// The per-point predicates of the count kernels and of the collect path's
// bit-mask kernels, in one place so that a count and the mask that comes
// with it cannot drift apart.
//
//   in_box            closed box on raw int32 coordinates (las.rs:101-146)
//   in_time_range     half-open GPS-time range on the order-preserving
//                     (hi, lo) int32 encoding of the f64 times
//
// The packed tests are apart, in bbox_planes.cuh (the packed box and, as
// one axis of it, the dictionary class test, DictTiles) and time_planes.cuh:
// none of them rebuilds a residual. The raw u8 class equality tests four
// bytes at once (__vcmpeq4) in both its count and its mask
// (class_tiles.cuh ClassRawTiles). The JAX counterparts of these two are
// bbox_mask_jnp_multi and time_mask_jnp_multi in
// adhoc_queries_pointclouds_tpu/ops/predicate.py (lines 235-268).
#pragma once

#include <cstdint>

namespace aqpc {

// b = [lo0, lo1, lo2, hi0, hi1, hi2].
__device__ __forceinline__ int in_box(int x, int y, int z, const int* b) {
  return (x >= b[0]) & (x <= b[3]) & (y >= b[1]) & (y <= b[4]) & (z >= b[2]) & (z <= b[5]);
}

// q = (q0h, q0l, q1h, q1l): q0 <= (th, tl) < q1 lexicographically, signed.
__device__ __forceinline__ int in_time_range(int th, int tl, const int (&q)[4]) {
  const int ge = (th > q[0]) | ((th == q[0]) & (tl >= q[1]));
  const int lt = (th < q[2]) | ((th == q[2]) & (tl < q[3]));
  return ge & lt;
}

}  // namespace aqpc

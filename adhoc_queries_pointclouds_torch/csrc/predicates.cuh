// The per-point predicates of the count kernels and of the collect path's
// bit-mask kernels, in one place so that a count and the mask that comes
// with it cannot drift apart.
//
//   in_box            closed box on raw int32 coordinates (las.rs:101-146)
//   in_time_range     half-open GPS-time range on the order-preserving
//                     (hi, lo) int32 encoding of the f64 times
//   dict_mask8        the dictionary-coded class test over 8 consecutive
//                     points rebuilt from bit-planar codes
//                     (unpack_planes.cuh), for the dictionary count
//                     (class_count_dict.cu) only; the dictionary mask tests
//                     on the code planes as they lie, as one axis of the
//                     packed box test (bbox_planes.cuh DictTiles), and the
//                     packed bbox and time tests are apart too, in
//                     bbox_planes.cuh and time_planes.cuh: none of them
//                     rebuilds a residual
//
// The raw u8 class equality tests four bytes at once (__vcmpeq4) in both
// its count (class_count.cu) and its mask (mask_bits.cu ClassRawTiles).
// Their JAX counterparts are bbox_mask_jnp_multi, time_mask_jnp_multi and
// class_mask_dict_jnp_multi in adhoc_queries_pointclouds_tpu/ops/predicate.py
// (lines 235-268, 604-606).
#pragma once

#include <cstdint>

#include "unpack_planes.cuh"

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

// Dictionary codes equal to the target code t (len(dict) on a miss), for
// class_count_dict.cu: the hit mask of points 8g..8g+7 (bit i = point
// 8g+i) for `valid` (1..8) points below n_valid; bits past `valid` are 0.
__device__ __forceinline__ unsigned dict_mask8(const PlaneRow& c, int t, int64_t block_size,
                                               int64_t g, int valid) {
  return group_valid_mask(valid) &
         range_mask8(c.row, block_size, c.nbytes, c.nbits, t, t, g, valid, c.aligned);
}

}  // namespace aqpc

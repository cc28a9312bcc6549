// The per-point predicates of the count kernels and of the collect path's
// bit-mask kernels, in one place so that a count and the mask that comes
// with it cannot drift apart.
//
//   in_box            closed box on raw int32 coordinates (las.rs:101-146)
//   in_time_range     half-open GPS-time range on the order-preserving
//                     (hi, lo) int32 encoding of the f64 times
//   class_matches     raw u8 class equality
//   *_mask8           the packed forms over 8 consecutive points rebuilt
//                     from bit-planar residuals (unpack_planes.cuh)
//
// Their JAX counterparts are bbox_mask_jnp_multi, time_mask_jnp_multi,
// class_mask_jnp_multi and the packed mask forms in
// adhoc_queries_pointclouds_tpu/ops/predicate.py (lines 235-268, 508-540,
// 604-606).
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

// A target outside 0..255 matches no byte.
__device__ __forceinline__ int class_matches(uint8_t c, int t) {
  return static_cast<int>(c) == t;
}

// Hit masks of points 8g..8g+7 (bit i = point 8g+i) for `valid` (1..8)
// points below n_valid; bits past `valid` are 0.

__device__ __forceinline__ unsigned bbox_packed_mask8(const PlaneRow& x, const PlaneRow& y,
                                                      const PlaneRow& z, const int* b,
                                                      int64_t block_size, int64_t g,
                                                      int valid) {
  unsigned m = group_valid_mask(valid);
  m &= range_mask8(x.row, block_size, x.nbytes, x.nbits, b[0], b[3], g, valid, x.aligned);
  m &= range_mask8(y.row, block_size, y.nbytes, y.nbits, b[1], b[4], g, valid, y.aligned);
  m &= range_mask8(z.row, block_size, z.nbytes, z.nbits, b[2], b[5], g, valid, z.aligned);
  return m;
}

// Dictionary codes equal to the target code t (len(dict) on a miss).
__device__ __forceinline__ unsigned dict_mask8(const PlaneRow& c, int t, int64_t block_size,
                                               int64_t g, int valid) {
  return group_valid_mask(valid) &
         range_mask8(c.row, block_size, c.nbytes, c.nbits, t, t, g, valid, c.aligned);
}

// Residual-space (hi, lo) words in the residual-space range q.
__device__ __forceinline__ unsigned time_packed_mask8(const PlaneRow& hi, const PlaneRow& lo,
                                                      const int (&q)[4], int64_t block_size,
                                                      int64_t g, int valid) {
  uint32_t h[8], l[8];
  unpack8(hi.row, block_size, hi.nbytes, hi.nbits, g, valid, hi.aligned, h);
  unpack8(lo.row, block_size, lo.nbytes, lo.nbits, g, valid, lo.aligned, l);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    m |= static_cast<unsigned>(in_time_range(static_cast<int>(h[i]), static_cast<int>(l[i]), q))
         << i;
  return m & group_valid_mask(valid);
}

}  // namespace aqpc

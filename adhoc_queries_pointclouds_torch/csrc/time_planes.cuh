// The half-open GPS-time range test of the two packed time kernels
// (time_count.cu and mask_time_packed in mask_bits.cu), done on the
// bit-planar planes of the hi and lo words as they lie in memory, with the
// loads and per-plane steps of bbox_planes.cuh: no residual is rebuilt.
//
// The test as one number. Row k's columns are k_hi and k_lo bits wide and
// q = qs[k] = (a_h, a_l, b_h, b_l) are int32 words in residual space. The
// reference tests (H, L) >= (a_h, a_l) and (H, L) < (b_h, b_l)
// lexicographically on the unpacked int32 words (time_mask_jnp_multi).
// Let u(v) be v for a column below 32 bits and v ^ 2^31, read unsigned,
// at 32 bits; a point is N = u(H) * 2^k_lo + u(L), W = k_hi + k_lo <= 64
// bits. A lo word of the query folds into c(v) = clamp(v, 0, 2^k_lo) below
// 32 bits (2^k_lo: it carries into hi) and u(v) at 32, so that with
// Q0 = u(a_h) * 2^k_lo + c(a_l) and Q1 = u(b_h) * 2^k_lo + c(b_l), exact
// integers, a point matches if and only if
//   max(Q0, 0) <= N <= min(Q1 - 1, 2^W - 1).
// time_row computes the two bounds once per row, in 128-bit integers (they
// reach 2^64 at (32, 32)); an empty interval sets the row's nv to 0, so its
// planes are never read: padding rows and start == end fall out so.
//
// The chains. N >= lo and N <= hi are "N - lo does not borrow" and "hi - N
// does not borrow" over the W bits, from the lowest plane up: lo's byte
// planes, lo's bit planes, hi's byte planes, hi's bit planes, each plane's
// bound bits from the row's two W-bit bounds. The byte and bit steps are
// bbox_planes.cuh's. Two hand-overs are new:
//   lo with no bit planes (k_lo % 8 == 0): the per-byte borrows pass from
//     lo's last byte plane straight into hi's first, since each u32 lane
//     holds the same four points in both columns: (20, 32) is one chain of
//     six byte planes, one gather, four bit planes;
//   lo with bit planes: after them the chains are 32-point words; the
//     borrow of point 4j + i goes back to bit 0 of byte i of lane j
//     (word_borrows) before hi's byte planes.
//
// Shapes: the byte planes of each column are template arguments, 25
// bodies, each with the wide and the narrow loads of bbox_planes.cuh and
// built for 2 or 4 CTAs an SM (kMinCtas); with_time_shape picks one on the
// host for the launch's widths.
#pragma once

#include <cstdint>

#include "bbox_planes.cuh"

namespace aqpc {

// One block row of a packed time step: lo and hi hold the row's two W-bit
// bounds, each column its own bits of them; nv is 0 when nothing matches.
struct TimeRow {
  Column lo, hi;
  int64_t nv;
};

// v's place among a k-bit column's residuals: v below 32 bits (it may lie
// outside [0, 2^k)), v ^ 2^31 read unsigned at 32.
__device__ __forceinline__ __int128 time_key(int v, int k) {
  if (k == 32) return static_cast<__int128>(static_cast<uint32_t>(v) ^ 0x80000000u);
  return v;
}

// A query's lo word folded into [0, 2^k] below 32 bits, where 2^k is
// "above every residual" (it carries into hi); time_key at 32.
__device__ __forceinline__ __int128 time_fold(int v, int k) {
  if (k == 32) return time_key(v, 32);
  const int64_t top = int64_t{1} << k;
  return v < 0 ? 0 : (v > top ? top : v);
}

__device__ __forceinline__ TimeRow time_row(const Planes& ph, const Planes& pl,
                                            const int32_t* __restrict__ qs,
                                            const int32_t* __restrict__ nvs, int64_t k,
                                            int64_t block_size) {
  const int32_t* q = qs + 4 * k;
  const int kh = 8 * ph.nbytes + ph.nbits;
  const int kl = 8 * pl.nbytes + pl.nbits;
  const __int128 one = 1;
  const __int128 q0 = time_key(q[0], kh) * (one << kl) + time_fold(q[1], kl);
  const __int128 q1 = time_key(q[2], kh) * (one << kl) + time_fold(q[3], kl);
  const __int128 top = (one << (kh + kl)) - 1;
  const __int128 lo = q0 > 0 ? q0 : 0;
  const __int128 hi = q1 - 1 < top ? q1 - 1 : top;
  // in [0, 2^W) when the interval holds a point: lo's bits, then hi's
  const uint64_t l = static_cast<uint64_t>(lo), h = static_cast<uint64_t>(hi);
  const uint64_t lo_mask = (uint64_t{1} << kl) - 1;
  TimeRow r;
  r.lo = Column{pl.planes + k * pl.row_width, pl.nbytes, pl.nbits,
                static_cast<uint32_t>(l & lo_mask), static_cast<uint32_t>(h & lo_mask)};
  r.hi = Column{ph.planes + k * ph.row_width, ph.nbytes, ph.nbits,
                static_cast<uint32_t>(l >> kl), static_cast<uint32_t>(h >> kl)};
  r.nv = lo <= hi ? clamp_valid(nvs[k], block_size) : 0;
  return r;
}

// A 32-point word of "not borrowed" flags (bit 4j + i: point 4j + i) as the
// borrows into the next byte plane: bit 0 of byte i of b[j].
__device__ __forceinline__ void word_borrows(uint32_t ok, uint32_t (&b)[8]) {
  const uint32_t borrowed = ~ok;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    // bits 0..3 -> bits 0, 8, 16, 24 (and bits in between, masked off): the
    // partial products land on distinct bits, so nothing carries
    b[j] = (((borrowed >> (4 * j)) & 0xfu) * 0x00204081u) & kByteOnes;
}

// Bit i: point 32w + i of row r lies in its range. Bits of points past the
// row's end are unspecified.
template <bool Wide, int NBL, int NBH>
__device__ __forceinline__ uint32_t time_range_word(const TimeRow& r, int64_t block_size,
                                                    int64_t w) {
  uint32_t xl[NBL > 0 ? NBL : 1][8], xh[NBH > 0 ? NBH : 1][8];
  uint32_t dl[7], dh[7];
  load_column<Wide, NBL>(r.lo, block_size, w, xl, dl);
  load_column<Wide, NBH>(r.hi, block_size, w, xh, dh);

  // the chains' state: none read yet, per byte in nl, nh (top bits) after a
  // byte plane, or per point in ok_lo, ok_hi after a bit plane
  enum { kFresh, kPerByte, kPerPoint } state = NBL > 0 ? kPerByte : kFresh;
  uint32_t nl[8], nh[8];
  uint32_t ok_lo = 0xffffffffu, ok_hi = 0xffffffffu;
  uint32_t bl[8] = {}, bh[8] = {};  // borrows into a column's first byte plane
  if constexpr (NBL > 0) byte_chain<NBL>(xl, r.lo.lo, r.lo.hi, bl, bh, nl, nh);
  if constexpr (NBL < 4) {
    if (r.lo.nbits > 0) {
      if (state == kPerByte) {
        ok_lo = byte_tops_to_bits(nl);
        ok_hi = byte_tops_to_bits(nh);
      }
      bit_chain<NBL>(dl, r.lo.nbits, r.lo.lo, r.lo.hi, &ok_lo, &ok_hi);
      state = kPerPoint;
    }
  }
  if constexpr (NBH > 0) {
    if (state == kPerByte) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bl[j] = byte_borrows(nl[j]);
        bh[j] = byte_borrows(nh[j]);
      }
    } else if (state == kPerPoint) {
      word_borrows(ok_lo, bl);
      word_borrows(ok_hi, bh);
    }
    byte_chain<NBH>(xh, r.hi.lo, r.hi.hi, bl, bh, nl, nh);
    state = kPerByte;
  }
  if (state == kPerByte) {
    if (NBH == 4 || r.hi.nbits == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) nl[j] &= nh[j];
      return byte_tops_to_bits(nl);
    }
    ok_lo = byte_tops_to_bits(nl);
    ok_hi = byte_tops_to_bits(nh);
  }
  if constexpr (NBH < 4) bit_chain<NBH>(dh, r.hi.nbits, r.hi.lo, r.hi.hi, &ok_lo, &ok_hi);
  return ok_lo & ok_hi;
}

// The packed time test as the tile loops of collect.cuh take it.
template <bool Wide, int NBL, int NBH>
struct TimeTiles {
  using Row = TimeRow;
  // CTAs an SM the body is built for (__launch_bounds__): 4, at 64
  // registers, for the wide bodies whose loads and chains (nearly) fit in
  // them: lo with no bit planes, or hi with at most one byte plane (with
  // CUDA 12.9, 6 of these 26 count and mask bodies spill 8 to 96 bytes); 2,
  // at 128, for the rest, where the spread's borrows and hi's byte planes
  // are live at once and would spill at 64. chip_smoke.py's phase 2 prints
  // every body that spills.
  static constexpr int kMinCtas = Wide && (NBL == 4 || NBH <= 1) ? 4 : 2;
  static constexpr bool kWarpWords = false;
  Planes ph, pl;
  const int32_t* qs;
  const int32_t* nvs;
  int64_t block_size;
  __device__ __forceinline__ Row row(int64_t k) const {
    return time_row(ph, pl, qs, nvs, k, block_size);
  }
  __device__ __forceinline__ uint32_t word(const Row& r, int64_t w) const {
    return valid_bits(r.nv, w) & time_range_word<Wide, NBL, NBH>(r, block_size, w);
  }
};

// f(TimeTiles<Wide, NBL, NBH>{ph, pl, qs, nvs, block_size}) for the body
// of the launch's shape: the wide loads (planes_wide) or not, and the byte
// planes of each column.
template <class F>
inline int with_time_shape(const Planes& ph, const Planes& pl, const void* qs, const void* nvs,
                           int64_t block_size, F&& f) {
  const bool wide = planes_wide(block_size, ph.planes, pl.planes);
  return with_int<1>(wide, [&](auto w) {
    return with_int<4>(pl.nbytes, [&](auto nbl) {
      return with_int<4>(ph.nbytes, [&](auto nbh) {
        return f(TimeTiles<decltype(w)::value != 0, decltype(nbl)::value,
                           decltype(nbh)::value>{ph, pl, static_cast<const int32_t*>(qs),
                                                 static_cast<const int32_t*>(nvs),
                                                 block_size});
      });
    });
  });
}

}  // namespace aqpc

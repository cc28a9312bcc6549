// The closed-box test of the two packed bbox kernels (bbox_count_packed.cu
// and mask_bbox_packed in mask_bits.cu), done on the bit-planar planes as
// they lie in memory: no residual is rebuilt.
//
// Layout: unpack_planes.cuh. A column of k = 8*nbytes + nbits bits is nbytes
// byte planes (bits 8p..8p+7 of every point) then nbits bit planes (one bit
// of every point, 8 points a byte, little bit order); k == 32 ships raw
// two's-complement words.
//
// The unit is one 32-point word: points 32w..32w+31 of one block row, the
// word the collect path's bit mask wants. For one axis, lo <= r <= hi is
// "r - lo does not borrow and hi - r does not borrow", and a subtraction's
// borrow runs from the lowest plane up, so each plane is read once and
// folded into two borrow chains:
//
//   byte planes  32 points are 32 bytes, eight u32 words of 4 points. With
//                the bound's byte c replicated four times and H the top bit
//                of each byte, (x | H) - (c & ~H) - borrow_in never borrows
//                across bytes and leaves "low 7 bits did not borrow" in each
//                byte's top bit; one three-input logic operation with x and
//                c's top bit makes it the whole byte's. About 2.5 integer
//                operations per point and plane for both bounds.
//   byte -> bit  the eight words' top bits are gathered into one 32-point
//                word per bound (a multiply moves four of them at once):
//                about 3 operations per point and axis, 1.5 when the column
//                has no bit planes and the two chains are ANDed first.
//   bit planes   one u32 is one bit of 32 points; each chain takes one
//                three-input logic operation per plane: 1/16 operation per
//                point and plane.
//
// Signedness: below 32 bits the residual is an unsigned k-bit number, so
// the int32 bounds are clamped into [0, 2^k - 1] first (a row whose clamped
// box is empty matches nothing: this is how padding rows, lo 0 / hi -1,
// fall out). At k == 32 the compare is signed: the top bit of the top byte
// plane and of both bounds is flipped, which maps the int32 order onto the
// unsigned one; nothing is clamped.
//
// Loads: the number of byte planes is a template argument (a switch picks
// one of five fully unrolled bodies), the bit planes are a fixed sequence of
// seven predicated loads, and every load of an axis is started before its
// first compare. A thread reads 32 consecutive bytes of a byte plane as two
// 16-byte loads and 4 bytes of a bit plane as one u32 (a warp: 128
// consecutive bytes). That wide path needs B % 128 == 0 and plane stacks on
// 16-byte boundaries, which makes every plane of every row 16-byte aligned.
// Any other legal shape (B % 8 == 0 only; or B % 8 != 0 with byte planes
// only; or an unaligned stack) takes the narrow path: the same compare on
// words gathered with byte loads, each index checked against the plane's
// end, so nothing outside the row is read.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "block_count.cuh"
#include "unpack_planes.cuh"

namespace aqpc {

constexpr uint32_t kByteTops = 0x80808080u;
constexpr uint32_t kByteOnes = 0x01010101u;

// One axis of one block row: its planes and its bounds as unsigned numbers
// in plane order (byte p of lo is the bound of byte plane p).
struct BoxAxis {
  const uint8_t* row;
  int nbytes;
  int nbits;
  uint32_t lo;
  uint32_t hi;
};

// One block row of a packed bbox step; nv is 0 when the box is empty.
struct BoxRow {
  BoxAxis x, y, z;
  int64_t nv;
};

// Whether every plane of every row of the three stacks can take the wide
// loads.
inline bool box_planes_wide(const void* xp, const void* yp, const void* zp,
                            int64_t block_size) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(yp) |
                         reinterpret_cast<uintptr_t>(zp);
  return block_size % 128 == 0 && addr % 16 == 0;
}

// SM count x resident CTAs of `kernel` at kThreads threads: the size of a
// persistent grid.
template <class Kernel>
inline int64_t resident_ctas(Kernel kernel) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t n = static_cast<int64_t>(sms) * per_sm;
  return n < 1 ? 1 : n;
}

// The axis of row k with its int32 residual-space bounds made unsigned;
// clears *some when no residual can lie in them.
__device__ __forceinline__ BoxAxis box_axis(const Planes& p, int64_t k, int lo, int hi,
                                            bool* some) {
  BoxAxis a{p.planes + k * p.row_width, p.nbytes, p.nbits, 0u, 0u};
  const int k_bits = 8 * p.nbytes + p.nbits;
  if (k_bits == 32) {
    a.lo = static_cast<uint32_t>(lo) ^ 0x80000000u;
    a.hi = static_cast<uint32_t>(hi) ^ 0x80000000u;
    return a;  // an empty box (lo > hi) fails one of the two chains
  }
  const int top = static_cast<int>((1u << k_bits) - 1u);
  const int l = lo < 0 ? 0 : lo;
  const int h = hi > top ? top : hi;
  if (l > h) *some = false;  // also hi < 0 and lo > top
  a.lo = static_cast<uint32_t>(l);
  a.hi = static_cast<uint32_t>(h);
  return a;
}

__device__ __forceinline__ BoxRow box_row(const Planes& ax, const Planes& ay, const Planes& az,
                                          const int32_t* __restrict__ bounds,
                                          const int32_t* __restrict__ nvs, int64_t k,
                                          int64_t block_size) {
  const int32_t* b = bounds + k * 6;
  bool some = true;
  BoxRow r;
  r.x = box_axis(ax, k, b[0], b[3], &some);
  r.y = box_axis(ay, k, b[1], b[4], &some);
  r.z = box_axis(az, k, b[2], b[5], &some);
  r.nv = some ? clamp_valid(nvs[k], block_size) : 0;
  return r;
}

// Bytes 32w..32w+31 of a byte plane of block_size bytes, as eight u32.
template <bool Wide>
__device__ __forceinline__ void load_byte_words(const uint8_t* __restrict__ plane,
                                                int64_t block_size, int64_t w,
                                                uint32_t (&x)[8]) {
  if (Wide) {
    const uint4* src = reinterpret_cast<const uint4*>(plane + 32 * w);
    const uint4 a = __ldg(src);
    const uint4 c = __ldg(src + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t idx = 32 * w + 4 * j + i;
        if (idx < block_size) x[j] |= static_cast<uint32_t>(plane[idx]) << (8 * i);
      }
    }
  }
}

// Bytes 4w..4w+3 of a bit plane of plane_bytes bytes: bit i is point 32w+i.
template <bool Wide>
__device__ __forceinline__ uint32_t load_bit_word(const uint8_t* __restrict__ plane,
                                                  int64_t plane_bytes, int64_t w) {
  if (Wide) return __ldg(reinterpret_cast<const uint32_t*>(plane + 4 * w));
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t idx = 4 * w + i;
    if (idx < plane_bytes) v |= static_cast<uint32_t>(plane[idx]) << (8 * i);
  }
  return v;
}

// The top bit of byte i of m[j] into bit 4j + i.
__device__ __forceinline__ uint32_t byte_tops_to_bits(const uint32_t (&m)[8]) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // bits 0, 8, 16, 24 -> bits 24..27: the partial products land on
    // distinct bits, so nothing carries
    const uint32_t four = (((m[j] >> 7) & kByteOnes) * 0x01020408u) >> 24;
    bits |= four << (4 * j);
  }
  return bits;
}

// Bit i: point 32w + i of the axis has lo <= residual <= hi. Bits of points
// past the row's end are unspecified.
template <bool Wide, int NB>
__device__ __forceinline__ uint32_t axis_word_nb(const BoxAxis& a, int64_t block_size,
                                                 int64_t w) {
  uint32_t x[NB > 0 ? NB : 1][8];
  uint32_t d[7];
#pragma unroll
  for (int p = 0; p < NB; ++p)
    load_byte_words<Wide>(a.row + p * block_size, block_size, w, x[p]);
  if (NB < 4) {
    const uint8_t* bit_planes = a.row + NB * block_size;
    const int64_t plane_bytes = block_size / 8;
#pragma unroll
    for (int q = 0; q < 7; ++q)
      d[q] = q < a.nbits ? load_bit_word<Wide>(bit_planes + q * plane_bytes, plane_bytes, w)
                         : 0u;
  }

  // per point: r - lo and hi - r have not borrowed so far
  uint32_t ok_lo = 0xffffffffu;
  uint32_t ok_hi = 0xffffffffu;
  if (NB > 0) {
    uint32_t nl[8], nh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t borrow_l = 0, borrow_h = 0;  // bit 0 of each byte
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        uint32_t v = x[p][j];
        if (NB == 4 && p == 3) v ^= kByteTops;  // signed top byte at k == 32
        const uint32_t cl = ((a.lo >> (8 * p)) & 0xffu) * kByteOnes;
        const uint32_t ch = ((a.hi >> (8 * p)) & 0xffu) * kByteOnes;
        // top bit of each byte: the low 7 bits did not borrow
        const uint32_t tl = (v | kByteTops) - (cl & ~kByteTops) - borrow_l;
        const uint32_t th = (ch | kByteTops) - (v & ~kByteTops) - borrow_h;
        // and with the top bits themselves: v - cl, ch - v did not borrow
        nl[j] = (v & tl) | (~cl & (v | tl));
        nh[j] = (~v & th) | (ch & (~v | th));
        borrow_l = (~nl[j] >> 7) & kByteOnes;
        borrow_h = (~nh[j] >> 7) & kByteOnes;
      }
    }
    if (NB == 4 || a.nbits == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) nl[j] &= nh[j];
      return byte_tops_to_bits(nl);
    }
    ok_lo = byte_tops_to_bits(nl);
    ok_hi = byte_tops_to_bits(nh);
  }
  if (NB < 4) {
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      if (q < a.nbits) {
        const uint32_t bl = ((a.lo >> (8 * NB + q)) & 1u) ? 0xffffffffu : 0u;
        const uint32_t bh = ((a.hi >> (8 * NB + q)) & 1u) ? 0xffffffffu : 0u;
        // bit - bound bit - borrow: bound bit 1 needs bit 1 and no borrow,
        // bound bit 0 needs either; and the mirror image for hi - bit
        ok_lo = (d[q] & ok_lo) | (~bl & (d[q] | ok_lo));
        ok_hi = (~d[q] & ok_hi) | (bh & (~d[q] | ok_hi));
      }
    }
  }
  return ok_lo & ok_hi;
}

template <bool Wide>
__device__ __forceinline__ uint32_t axis_word(const BoxAxis& a, int64_t block_size, int64_t w) {
  switch (a.nbytes) {
    case 0: return axis_word_nb<Wide, 0>(a, block_size, w);
    case 1: return axis_word_nb<Wide, 1>(a, block_size, w);
    case 2: return axis_word_nb<Wide, 2>(a, block_size, w);
    case 3: return axis_word_nb<Wide, 3>(a, block_size, w);
    default: return axis_word_nb<Wide, 4>(a, block_size, w);
  }
}

// The hit word of points 32w..32w+31 of row r (bit i = point 32w + i);
// 32w < r.nv. Bits of points at or past r.nv are 0.
template <bool Wide>
__device__ __forceinline__ uint32_t box_word(const BoxRow& r, int64_t block_size, int64_t w) {
  const int64_t left = r.nv - 32 * w;
  const uint32_t valid = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  return valid & axis_word<Wide>(r.x, block_size, w) & axis_word<Wide>(r.y, block_size, w) &
         axis_word<Wide>(r.z, block_size, w);
}

}  // namespace aqpc

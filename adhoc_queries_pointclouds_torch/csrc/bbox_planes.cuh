// The closed-box test of the two packed bbox kernels (bbox_count_packed.cu
// and mask_bbox_packed in mask_bits.cu), done on the bit-planar planes as
// they lie in memory: no residual is rebuilt. Its loads and per-plane steps
// also make the packed GPS-time test (time_planes.cuh), whose two chains
// run on through a second column, and one axis of it at lo = hi = the
// target code is the dictionary class mask (DictTiles, mask_class_dict in
// mask_bits.cu).
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
//                c's top bit makes it the whole byte's (byte_step). About
//                2.5 integer operations per point and plane for both bounds.
//   byte -> bit  the eight words' top bits are gathered into one 32-point
//                word per bound (a multiply moves four of them at once):
//                about 3 operations per point and axis, 1.5 when the column
//                has no bit planes and the two chains are ANDed first.
//   bit planes   one u32 is one bit of 32 points; each chain takes one
//                three-input logic operation per plane (bit_chain): 1/16
//                operation per point and plane.
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

// One column of one block row: its planes and its bounds as unsigned
// numbers in plane order (byte p of lo is the bound of byte plane p, bit
// 8 * nbytes + q that of bit plane q).
struct Column {
  const uint8_t* row;
  int nbytes;
  int nbits;
  uint32_t lo;
  uint32_t hi;
};

// One block row of a packed bbox step; nv is 0 when the box is empty.
struct BoxRow {
  Column x, y, z;
  int64_t nv;
};

// Whether every plane of every row of the stacks can take the wide loads.
template <class... Stacks>
inline bool planes_wide(int64_t block_size, const Stacks*... stacks) {
  const uintptr_t addr = (reinterpret_cast<uintptr_t>(stacks) | ...);
  return block_size % 128 == 0 && addr % 16 == 0;
}

// The axis of row k with its int32 residual-space bounds made unsigned;
// clears *some when no residual can lie in them.
__device__ __forceinline__ Column box_axis(const Planes& p, int64_t k, int lo, int hi,
                                           bool* some) {
  Column a{p.planes + k * p.row_width, p.nbytes, p.nbits, 0u, 0u};
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

// Bytes 32w..32w+31 of a byte plane of block_size bytes, as eight u32; all
// 0, and nothing read, unless `in`.
template <bool Wide>
__device__ __forceinline__ void load_byte_words(const uint8_t* __restrict__ plane,
                                                int64_t block_size, int64_t w,
                                                uint32_t (&x)[8], bool in = true) {
  if (Wide) {
    const uint4* src = reinterpret_cast<const uint4*>(plane + 32 * w);
    const uint4 a = in ? __ldg(src) : make_uint4(0, 0, 0, 0);
    const uint4 c = in ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t idx = 32 * w + 4 * j + i;
        if (in && idx < block_size) x[j] |= static_cast<uint32_t>(plane[idx]) << (8 * i);
      }
    }
  }
}

// Bytes 4w..4w+3 of a bit plane of plane_bytes bytes: bit i is point 32w+i;
// 0, and nothing read, unless `in`.
template <bool Wide>
__device__ __forceinline__ uint32_t load_bit_word(const uint8_t* __restrict__ plane,
                                                  int64_t plane_bytes, int64_t w,
                                                  bool in = true) {
  if (Wide) return in ? __ldg(reinterpret_cast<const uint32_t*>(plane + 4 * w)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t idx = 4 * w + i;
    if (in && idx < plane_bytes) v |= static_cast<uint32_t>(plane[idx]) << (8 * i);
  }
  return v;
}

// Every plane of column a at word w: NB byte planes into x, then (NB < 4)
// the first MB bit planes into d, bit planes past a.nbits 0 (MB = 7 takes
// any column; a body built for one width, MB = its nbits, loads them with
// no branch). All loads are started here, before any compare, and only
// when `in` (predicated).
template <bool Wide, int NB, int MB = 7>
__device__ __forceinline__ void load_column(const Column& a, int64_t block_size, int64_t w,
                                            uint32_t (&x)[NB > 0 ? NB : 1][8],
                                            uint32_t (&d)[MB > 0 ? MB : 1], bool in = true) {
#pragma unroll
  for (int p = 0; p < NB; ++p)
    load_byte_words<Wide>(a.row + p * block_size, block_size, w, x[p], in);
  if constexpr (NB < 4) {
    const uint8_t* bit_planes = a.row + NB * block_size;
    const int64_t plane_bytes = block_size / 8;
#pragma unroll
    for (int q = 0; q < MB; ++q)
      d[q] = MB < 7 || q < a.nbits  // a body built for its width has them all
                 ? load_bit_word<Wide>(bit_planes + q * plane_bytes, plane_bytes, w, in)
                 : 0u;
  }
}

// Byte p of bound, replicated into the four bytes of a u32.
__device__ __forceinline__ uint32_t bound_bytes(uint32_t bound, int p) {
  return ((bound >> (8 * p)) & 0xffu) * kByteOnes;
}

// One byte plane v (four points, a byte each) of both chains. borrow_l,
// borrow_h: the borrows into this plane, bit 0 of each byte. Out: the top
// bit of each byte of *nl is "v - cl has not borrowed out of this plane",
// of *nh "ch - v has not"; cl, ch are the bounds' bytes, replicated.
__device__ __forceinline__ void byte_step(uint32_t v, uint32_t cl, uint32_t ch,
                                          uint32_t borrow_l, uint32_t borrow_h, uint32_t* nl,
                                          uint32_t* nh) {
  // top bit of each byte: the low 7 bits did not borrow
  const uint32_t tl = (v | kByteTops) - (cl & ~kByteTops) - borrow_l;
  const uint32_t th = (ch | kByteTops) - (v & ~kByteTops) - borrow_h;
  // and with the top bits themselves: v - cl, ch - v did not borrow
  *nl = (v & tl) | (~cl & (v | tl));
  *nh = (~v & th) | (ch & (~v | th));
}

// The borrow into the next byte plane (bit 0 of each byte) from a step's
// "not borrowed" top bits.
__device__ __forceinline__ uint32_t byte_borrows(uint32_t n) { return (~n >> 7) & kByteOnes; }

// Both chains through the NB byte planes x of a column, lane by lane, from
// the borrows bl, bh into its first plane; nl, nh take the top bits of the
// last. At NB == 4 the column is 32 bits wide and signed: its top byte's
// top bit is flipped.
template <int NB>
__device__ __forceinline__ void byte_chain(const uint32_t (&x)[NB][8], uint32_t lo, uint32_t hi,
                                           const uint32_t (&bl)[8], const uint32_t (&bh)[8],
                                           uint32_t (&nl)[8], uint32_t (&nh)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t borrow_l = bl[j], borrow_h = bh[j];
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      uint32_t v = x[p][j];
      if (NB == 4 && p == 3) v ^= kByteTops;  // signed top byte at k == 32
      byte_step(v, bound_bytes(lo, p), bound_bytes(hi, p), borrow_l, borrow_h, &nl[j], &nh[j]);
      borrow_l = byte_borrows(nl[j]);
      borrow_h = byte_borrows(nh[j]);
    }
  }
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

// Both chains through the bit planes d of a column with NB byte planes:
// bit plane q holds bit 8 * NB + q of the column, and ok_lo, ok_hi carry
// "not borrowed so far" of all 32 points.
template <int NB, int MB = 7>
__device__ __forceinline__ void bit_chain(const uint32_t (&d)[MB > 0 ? MB : 1], int nbits,
                                          uint32_t lo, uint32_t hi, uint32_t* ok_lo,
                                          uint32_t* ok_hi) {
#pragma unroll
  for (int q = 0; q < MB; ++q) {
    if (q < nbits) {
      const uint32_t bl = ((lo >> (8 * NB + q)) & 1u) ? 0xffffffffu : 0u;
      const uint32_t bh = ((hi >> (8 * NB + q)) & 1u) ? 0xffffffffu : 0u;
      // bit - bound bit - borrow: bound bit 1 needs bit 1 and no borrow,
      // bound bit 0 needs either; and the mirror image for hi - bit
      *ok_lo = (d[q] & *ok_lo) | (~bl & (d[q] | *ok_lo));
      *ok_hi = (~d[q] & *ok_hi) | (bh & (~d[q] | *ok_hi));
    }
  }
}

// Bit i: point i of the 32 whose planes load_column gave, x and d, has lo
// <= residual <= hi.
template <int NB, int MB = 7>
__device__ __forceinline__ uint32_t axis_chains(const Column& a,
                                                const uint32_t (&x)[NB > 0 ? NB : 1][8],
                                                const uint32_t (&d)[MB > 0 ? MB : 1]) {
  // per point: r - lo and hi - r have not borrowed so far
  uint32_t ok_lo = 0xffffffffu;
  uint32_t ok_hi = 0xffffffffu;
  if constexpr (NB > 0) {
    const uint32_t none[8] = {};
    uint32_t nl[8], nh[8];
    byte_chain<NB>(x, a.lo, a.hi, none, none, nl, nh);
    if (NB == 4 || a.nbits == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) nl[j] &= nh[j];
      return byte_tops_to_bits(nl);
    }
    ok_lo = byte_tops_to_bits(nl);
    ok_hi = byte_tops_to_bits(nh);
  }
  if constexpr (NB < 4) bit_chain<NB, MB>(d, a.nbits, a.lo, a.hi, &ok_lo, &ok_hi);
  return ok_lo & ok_hi;
}

// Bit i: point 32w + i of the axis has lo <= residual <= hi. Bits of points
// past the row's end are unspecified.
template <bool Wide, int NB>
__device__ __forceinline__ uint32_t axis_word_nb(const Column& a, int64_t block_size,
                                                 int64_t w) {
  uint32_t x[NB > 0 ? NB : 1][8];
  uint32_t d[7];
  load_column<Wide, NB>(a, block_size, w, x, d);
  return axis_chains<NB>(a, x, d);
}

template <bool Wide>
__device__ __forceinline__ uint32_t axis_word(const Column& a, int64_t block_size, int64_t w) {
  switch (a.nbytes) {
    case 0: return axis_word_nb<Wide, 0>(a, block_size, w);
    case 1: return axis_word_nb<Wide, 1>(a, block_size, w);
    case 2: return axis_word_nb<Wide, 2>(a, block_size, w);
    case 3: return axis_word_nb<Wide, 3>(a, block_size, w);
    default: return axis_word_nb<Wide, 4>(a, block_size, w);
  }
}

// Word w's points below nv: bit i is set when 32w + i < nv; 32w < nv.
__device__ __forceinline__ uint32_t valid_bits(int64_t nv, int64_t w) {
  const int64_t left = nv - 32 * w;
  return left >= 32 ? 0xffffffffu : (1u << left) - 1u;
}

// The hit word of points 32w..32w+31 of row r (bit i = point 32w + i);
// 32w < r.nv. Bits of points at or past r.nv are 0.
template <bool Wide>
__device__ __forceinline__ uint32_t box_word(const BoxRow& r, int64_t block_size, int64_t w) {
  return valid_bits(r.nv, w) & axis_word<Wide>(r.x, block_size, w) &
         axis_word<Wide>(r.y, block_size, w) & axis_word<Wide>(r.z, block_size, w);
}

// The packed bbox test as the tile loops of collect.cuh take it.
template <bool Wide>
struct BoxTiles {
  using Row = BoxRow;
  static constexpr int kMinCtas = 2;  // CTAs an SM the body is built for
  static constexpr bool kWarpWords = false;
  Planes ax, ay, az;
  const int32_t* bounds;
  const int32_t* nvs;
  int64_t block_size;
  __device__ __forceinline__ Row row(int64_t k) const {
    return box_row(ax, ay, az, bounds, nvs, k, block_size);
  }
  __device__ __forceinline__ uint32_t word(const Row& r, int64_t w) const {
    return box_word<Wide>(r, block_size, w);
  }
};

// One block row of the dictionary class test; nv is 0 when the target code
// lies outside the column's codes (a miss, len(dict), can exceed 2^k - 1).
struct DictRow {
  Column c;
  int64_t nv;
};

// The dictionary-coded class test (code == target code, a miss never
// matching) as the tile loops of collect.cuh take it: one axis of the box
// test with lo = hi = the target code, on the code planes as they lie. At
// k <= 8 a column has at most one byte plane (NB), so a body holds one
// axis_word_nb and few registers. A count's body is built for its bit
// planes too (MB, the column's nbits; the mask's takes up to 7): a word's
// planes then take 8 NB + MB registers.
template <bool Wide, int NB, int MB = 7>
struct DictTiles {
  using Row = DictRow;
  // a thread's planes of its word, for a count (collect.cuh count_tiles)
  struct Loads {
    uint32_t x[NB > 0 ? NB : 1][8];
    uint32_t d[MB > 0 ? MB : 1];
  };
  static constexpr int kMinCtas = 4;  // CTAs an SM the body is built for
  static constexpr bool kWarpWords = false;
  Planes cp;
  const int32_t* targets;
  const int32_t* nvs;
  int64_t block_size;
  __device__ __forceinline__ Row row(int64_t k) const {
    bool some = true;
    const int t = targets[k];
    Row r;
    r.c = box_axis(cp, k, t, t, &some);
    r.nv = some ? clamp_valid(nvs[k], block_size) : 0;
    return r;
  }
  __device__ __forceinline__ uint32_t word(const Row& r, int64_t w) const {
    return valid_bits(r.nv, w) & axis_word_nb<Wide, NB>(r.c, block_size, w);
  }
  // word's loads, made only for 32w < r.nv, and the hits of its word
  __device__ __forceinline__ void load(const Row& r, int64_t w, Loads& ld) const {
    load_column<Wide, NB, MB>(r.c, block_size, w, ld.x, ld.d, 32 * w < r.nv);
  }
  __device__ __forceinline__ int hits(const Row& r, int64_t w, const Loads& ld) const {
    return 32 * w < r.nv ? __popc(valid_bits(r.nv, w) & axis_chains<NB, MB>(r.c, ld.x, ld.d))
                         : 0;
  }
};

}  // namespace aqpc

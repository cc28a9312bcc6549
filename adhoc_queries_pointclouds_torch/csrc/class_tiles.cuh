// The raw u8 class test (class == target) as the tile loops of collect.cuh
// take it: the mask word of mask_class (mask_bits.cu) and the count of
// class_count.cu, one body for both, so that the two cannot drift apart.
//
// Each row holds the target replicated into the four bytes of a word, and
// __vcmpeq4 tests four points an instruction. Two target rules: the u8
// entries (the class mask, the u8 count) compare the byte as an int, so a
// target outside 0..255 matches nothing and its row is not read; the word
// entry (the (K, B/4) int32 view) replicates any int32 target as
// uint32(t) * 0x01010101 and compares byte i of a 4-byte word with byte i
// of that (predicate.py:733-779 in the JAX package), which for a target
// outside 0..255 tests each byte position against another byte.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "block_count.cuh"
#include "collect.cuh"

namespace aqpc {

// One block row of the raw class test; nv is 0 when no byte can equal the
// target (u8 rule, a target outside 0..255).
struct ClassRawRow {
  const uint8_t* c;
  uint32_t rep;  // the target's byte in each byte of a word (word rule: uint32(t) * 0x01010101)
  int64_t nv;
};

// Bit i (i < 4): byte i of w equals byte i of rep.
__device__ __forceinline__ uint32_t equal_nibble(uint32_t w, uint32_t rep) {
  // 0xff at each equal byte; keep bit i of byte i and add the four bytes
  return ((__vcmpeq4(w, rep) & 0x08040201u) * 0x01010101u) >> 24;
}

// The low n bytes of a word, n clamped to [0, 4].
__device__ __forceinline__ uint32_t keep_bytes(int n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

// Eight times the bytes of w that equal their byte of rep, among `keep`.
__device__ __forceinline__ int equal_bits(uint32_t w, uint32_t rep, uint32_t keep) {
  return __popc(__vcmpeq4(w, rep) & keep);
}

// A warp makes its 32 words together (kWarpWords), lane L word w0 + L. Wide
// (B % 16 == 0, rows on 16-byte boundaries): lane L tests points
// 16L..16L+15 of each 512-point span of the warp's 1024 from one uint4 (a
// warp's load: 512 consecutive bytes), both spans' loads in flight before
// the first compare; __vcmpeq4 against the target's byte in all four
// bytes tests four points an instruction, the four byte masks make 16
// bits, one __shfl_xor_sync pairs lanes 2m and 2m + 1 into word 16s + m of
// the warp, and one __shfl_sync hands each lane its word. Otherwise (any
// B, rows on any boundary) lane L reads the 4-byte word holding points
// 4L..4L+3 of each 128-point span less the row's offset a past a 4-byte
// boundary (a warp's load: 128 consecutive bytes), all eight in flight,
// takes the next word from lane L + 1 with one shuffle and shifts the pair
// by a bytes (__funnelshift_r), tests the four points with __vcmpeq4, and
// eight lanes OR their 4-bit results into a word with three
// __shfl_xor_sync, as TimeRawTiles does. A word is read only when it holds
// a point below nv (its other bytes, up to 3 before the row or past nv,
// lie in the same aligned 4 bytes as a point of the row and are shifted
// out or masked), and every load is streaming (__ldcs). (Byte loads and
// one __ballot_sync a word, 32 loads in flight, were slower than a CTA a
// chunk with a ballot a word: PERF.md section 6.)
//
// A count needs no word: load(r, w, ld) makes the same loads, and
// hits(r, w, ld) adds, with no shuffle, the equal bytes of the lane's own
// loads that are points of the warp's 1024 below nv (__popc of __vcmpeq4
// under a byte mask). The word entry's rows lie on 4-byte boundaries (a =
// 0), so byte i of a loaded word meets byte i of rep, as the word rule
// wants.
// A lane's loads of the warp's 1024 points: two uint4 (wide), or eight
// aligned 4-byte words and, lane 0 only, the word after them, with the
// row's offset a past a 4-byte boundary (narrow).
struct ClassWideLoads {
  uint4 v[2];
};
struct ClassNarrowLoads {
  uint32_t x[9];
  int a;
};

template <bool Wide>
struct ClassRawTiles {
  using Row = ClassRawRow;
  using Loads = std::conditional_t<Wide, ClassWideLoads, ClassNarrowLoads>;
  static constexpr int kMinCtas = 8;  // CTAs an SM the mask body is built for
  static constexpr bool kWarpWords = true;
  const uint8_t* cls;
  const int32_t* targets;
  const int32_t* nvs;
  int64_t block_size;
  bool words;  // the word entry's target rule
  __device__ __forceinline__ Row row(int64_t k) const {
    Row r;
    r.c = cls + k * block_size;
    const int t = targets[k];
    r.rep = static_cast<uint32_t>(t) * 0x01010101u;
    r.nv = words || (t >= 0 && t <= 255) ? clamp_valid(nvs[k], block_size) : 0;
    return r;
  }

  // The lane's loads of the warp of word w, each made only below nv (no
  // branch: a count issues several warps' loads before it counts one).
  // Narrow: word q0 + 32j + L holds row bytes 4(q0 + 32j + L) - a ...
  __device__ __forceinline__ void load(const Row& r, int64_t w, Loads& ld) const {
    const int lane = threadIdx.x & 31;
    const int64_t p0 = 32 * (w - lane);  // the warp's first point
    if constexpr (Wide) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int64_t i = p0 + 512 * s + 16 * lane;
        ld.v[s] = i < r.nv ? __ldcs(reinterpret_cast<const uint4*>(r.c + i))
                           : make_uint4(0, 0, 0, 0);
      }
    } else {
      ld.a = static_cast<int>(reinterpret_cast<uintptr_t>(r.c) & 3);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(r.c - ld.a);
      const int64_t q0 = p0 / 4;
      const int64_t end = r.nv + ld.a;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int64_t q = q0 + 32 * j + lane;
        ld.x[j] = (j < 8 || lane == 0) && 4 * q < end ? __ldcs(words + q) : 0u;
      }
    }
  }

  __device__ __forceinline__ uint32_t word(const Row& r, int64_t w) const {
    const int lane = threadIdx.x & 31;
    Loads ld;
    load(r, w, ld);
    uint32_t mine = 0;
    if constexpr (Wide) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint4& v = ld.v[s];
        const uint32_t half = equal_nibble(v.x, r.rep) | equal_nibble(v.y, r.rep) << 4 |
                              equal_nibble(v.z, r.rep) << 8 | equal_nibble(v.w, r.rep) << 12;
        const uint32_t other = __shfl_xor_sync(0xffffffffu, half, 1);
        const uint32_t pair = (lane & 1) ? (other | half << 16) : (half | other << 16);
        // lanes 2m and 2m + 1 now hold word 16s + m of the warp
        const uint32_t got = __shfl_sync(0xffffffffu, pair, 2 * (lane & 15));
        if ((lane >> 4) == s) mine = got;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // lane L's points 128j + 4L .. + 3 end in the next word: lane L + 1's
        // of this span, or lane 0's of the next span for lane 31
        const uint32_t hi =
            __shfl_sync(0xffffffffu, lane == 0 ? ld.x[j + 1] : ld.x[j], (lane + 1) & 31);
        uint32_t v = equal_nibble(__funnelshift_r(ld.x[j], hi, 8 * ld.a), r.rep)
                     << (4 * (lane & 7));
        v |= __shfl_xor_sync(0xffffffffu, v, 1);
        v |= __shfl_xor_sync(0xffffffffu, v, 2);
        v |= __shfl_xor_sync(0xffffffffu, v, 4);
        // lanes 8g..8g+7 now hold word 4j + g of the warp
        const uint32_t got = __shfl_sync(0xffffffffu, v, 8 * (lane & 3));
        if ((lane >> 2) == j) mine = got;
      }
    }
    return mine & valid_any(r.nv, w);
  }

  // The lane's share of the hits of the warp of word w from its loads: 0
  // for a warp at or past nv.
  __device__ __forceinline__ int hits(const Row& r, int64_t w, const Loads& ld) const {
    const int lane = threadIdx.x & 31;
    const int64_t p0 = 32 * (w - lane);  // the warp's first point
    // the warp's points below nv, past p0: at most 1024
    const int64_t rest = r.nv - p0;
    const int left = rest < 1024 ? (rest > 0 ? static_cast<int>(rest) : 0) : 1024;
    int bits = 0;
    if constexpr (Wide) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int at = left - (512 * s + 16 * lane);  // lane's points below nv
        bits += equal_bits(ld.v[s].x, r.rep, keep_bytes(at)) +
                equal_bits(ld.v[s].y, r.rep, keep_bytes(at - 4)) +
                equal_bits(ld.v[s].z, r.rep, keep_bytes(at - 8)) +
                equal_bits(ld.v[s].w, r.rep, keep_bytes(at - 12));
      }
    } else {
      // word q0 + 32j + L holds the warp's points f .. f + 3, f = 128j + 4L - a
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int f = 128 * j + 4 * lane - ld.a;
        const uint32_t keep = keep_bytes(left - f) & ~keep_bytes(-f);
        if (j < 8 || lane == 0) bits += equal_bits(ld.x[j], r.rep, keep);
      }
    }
    return bits >> 3;
  }
};

}  // namespace aqpc

// Bit-planar residual unpack of the packed density pass; the layout and
// the Planes argument below also serve the packed bbox and GPS-time
// kernels and the dictionary class count and mask, which compare without
// unpacking (bbox_planes.cuh, time_planes.cuh).
//
// Layout of one column, one block row of the (K, nbytes*B + nbits*B/8) u8
// stack (k = 8*nbytes + nbits bits): byte plane p holds bits 8p..8p+7 of
// each point's u32 residual at [p*B, (p+1)*B); bit plane q holds bit
// 8*nbytes+q at [nbytes*B + q*B/8, ...), point i in bit i%8 of byte i/8
// (little bit order). k = 0 is legal (no planes, residual 0). k = 32 ships
// raw two's-complement words: the residual's top byte lands in the sign bit
// exactly as the int32 shift does in the reference (unpack_bits_jnp,
// adhoc_queries_pointclouds_tpu/ops/predicate.py:480-496). B % 8 == 0
// whenever nbits > 0.
//
// A thread rebuilds 8 consecutive points of a column in registers: one
// 8-byte load from each byte plane (neighbouring threads on neighbouring
// 8-byte words) and one byte from each bit plane, never materialising the
// int32 residuals in memory. A row whose planes are not 8-byte aligned
// takes byte loads.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aqpc {

struct Planes {
  const uint8_t* planes;  // (K, row_width) u8
  int64_t row_width;
  int nbytes;
  int nbits;
};

// Bit planes need B % 8 == 0 (whole bytes of 8 points each).
inline bool width_ok(int64_t k_bits, int64_t max_bits, int64_t block_size) {
  return k_bits >= 0 && k_bits <= max_bits && (k_bits % 8 == 0 || block_size % 8 == 0);
}

inline Planes make_planes(const void* planes, int64_t k_bits, int64_t block_size) {
  const int nbytes = static_cast<int>(k_bits / 8);
  const int nbits = static_cast<int>(k_bits % 8);
  return Planes{static_cast<const uint8_t*>(planes),
                nbytes * block_size + nbits * (block_size / 8), nbytes, nbits};
}

// Whether the byte planes of row k can take 8-byte loads.
__device__ __forceinline__ bool rows_aligned(const uint8_t* row, int64_t block_size) {
  return block_size % 8 == 0 && reinterpret_cast<uintptr_t>(row) % 8 == 0;
}

// One block row of a plane stack.
struct PlaneRow {
  const uint8_t* row;
  int nbytes;
  int nbits;
  bool aligned;
};

__device__ __forceinline__ PlaneRow plane_row(const Planes& p, int64_t k, int64_t block_size) {
  const uint8_t* row = p.planes + k * p.row_width;
  return PlaneRow{row, p.nbytes, p.nbits, rows_aligned(row, block_size)};
}

// Residuals r[i] of points 8g+i of one row. `valid` (1..8) is the number of
// points of the group below n_valid; bytes of points past it are not read
// and their r[i] are unspecified. Streaming: the loads are __ldcs (evict
// first), for a kernel that keeps other data hot in L2.
template <bool Streaming = false>
__device__ __forceinline__ void unpack8(const uint8_t* __restrict__ row, int64_t block_size,
                                        int nbytes, int nbits, int64_t g, int valid,
                                        bool aligned, uint32_t (&r)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0;
  for (int p = 0; p < nbytes; ++p) {
    const uint8_t* src = row + p * block_size + 8 * g;
    if (aligned && valid == 8) {
      const uint2* src2 = reinterpret_cast<const uint2*>(src);
      const uint2 w = Streaming ? __ldcs(src2) : *src2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] |= ((w.x >> (8 * i)) & 0xffu) << (8 * p);
        r[i + 4] |= ((w.y >> (8 * i)) & 0xffu) << (8 * p);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < valid)
          r[i] |= static_cast<uint32_t>(Streaming ? __ldcs(src + i) : src[i]) << (8 * p);
    }
  }
  const uint8_t* bits = row + nbytes * block_size + g;
  const int64_t bit_plane = block_size / 8;
  for (int q = 0; q < nbits; ++q) {
    const uint32_t byte = Streaming ? __ldcs(bits + q * bit_plane) : bits[q * bit_plane];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] |= ((byte >> i) & 1u) << (8 * nbytes + q);
  }
}

// Mask of the first `valid` (1..8) points of a group.
__device__ __forceinline__ unsigned group_valid_mask(int valid) {
  return valid >= 8 ? 0xffu : (1u << valid) - 1u;
}

}  // namespace aqpc

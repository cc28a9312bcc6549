// Shared pieces of the collect path's two kernels: the bit-mask layout,
// the chunking that links the mask kernels' per-chunk counts to the
// compaction's prefix, and the persistent tile loops of the count and mask
// kernels that walk (block, chunk) tiles.
//
// Bit mask of one block: ceil(B / 32) uint32 words, bit j of word w is row
// 32w + j; rows >= n_valid and the bits past B in the last word are 0.
// A chunk is kChunkWords consecutive words of one block (8192 rows): every
// mask kernel writes each chunk's hit count. The raw bbox mask runs one CTA
// per (chunk, block) (mask_bits.cu mask_rows); every other mask runs on
// mask_tiles below, a CTA walking tiles of one chunk each. The compaction
// (compact_bits.cu) runs one CTA per (chunk, block) tile, a warp per 32
// words, and starts its output at the block's offset plus the counts of
// the chunks before it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "block_count.cuh"

namespace aqpc {

constexpr int64_t kChunkWords = kThreads;

inline int64_t mask_words(int64_t block_size) { return (block_size + 31) / 32; }

inline int64_t mask_chunks(int64_t block_size) {
  return (mask_words(block_size) + kChunkWords - 1) / kChunkWords;
}

// Where a mask kernel writes: bits (K, n_words) uint32, counts (K,) int32
// zeroed by the caller, chunks (K, n_chunks) int32.
struct MaskOut {
  uint32_t* bits;
  int32_t* counts;
  int32_t* chunks;
  int64_t n_words;
  int64_t n_chunks;
};

// The chunk's count into chunks[k, c] and counts[k], for the CTA of chunk
// blockIdx.x of block blockIdx.y. Every thread calls it.
__device__ __forceinline__ void finish_chunk(int count, const MaskOut& o) {
  const int64_t k = blockIdx.y;
  count = cta_sum(count);
  if (threadIdx.x == 0) {
    o.chunks[k * o.n_chunks + blockIdx.x] = count;
    if (count) atomicAdd(o.counts + k, count);
  }
}

// Persistent grids over (block, chunk) tiles: tile t is chunk t % n_chunks
// of block t / n_chunks, and CTA b walks tiles b, b + gridDim.x, ... (its
// rows never decrease), one mask word a thread. A Tiles test gives Row
// row(k) (nv 0 when no point of row k can match) and uint32_t word(r, w),
// the hit word of points 32w..32w+31 of row r for 32w < r.nv, with the
// bits at or past r.nv 0. A test with kWarpWords makes a warp's 32 words
// together: every lane of a warp whose first word is below r.nv calls
// word(r, w) at once (the mask loop only), and the lanes past r.nv get 0.

// out[k] += the hits of row k (out zeroed by the caller): the count stays in
// registers while the row is the same, one cta_add per row a CTA touched.
template <class Tiles>
__device__ __forceinline__ void count_tiles(const Tiles& f, int32_t* __restrict__ out,
                                            int64_t n_chunks, int64_t n_tiles) {
  typename Tiles::Row r;
  int64_t row = -1;
  int count = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t k = t / n_chunks;
    if (k != row) {
      if (row >= 0) {
        cta_add(count, out + row);
        __syncthreads();  // cta_add's shared sums are free again
      }
      count = 0;
      row = k;
      r = f.row(k);
    }
    const int64_t w = (t % n_chunks) * kChunkWords + threadIdx.x;
    if (32 * w < r.nv) count += __popc(f.word(r, w));
  }
  if (row >= 0) cta_add(count, out + row);
}

// The mask of k_blocks rows into o: words, chunk counts and row counts.
template <class Tiles>
__device__ __forceinline__ void mask_tiles(const Tiles& f, const MaskOut& o, int64_t k_blocks) {
  typename Tiles::Row r;
  int64_t row = -1;
  const int64_t n_tiles = o.n_chunks * k_blocks;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t k = t / o.n_chunks;
    const int64_t c = t % o.n_chunks;
    if (k != row) {
      row = k;
      r = f.row(k);
    }
    const int64_t w = c * kChunkWords + threadIdx.x;
    uint32_t word = 0;
    if constexpr (Tiles::kWarpWords) {
      const int64_t w0 = w - (threadIdx.x & 31);  // the warp's first word
      if (w0 < o.n_words && 32 * w0 < r.nv) word = f.word(r, w);
      if (w < o.n_words) o.bits[k * o.n_words + w] = word;
    } else if (w < o.n_words) {
      if (32 * w < r.nv) word = f.word(r, w);
      o.bits[k * o.n_words + w] = word;
    }
    const int count = cta_sum(__popc(word));
    if (threadIdx.x == 0) {
      o.chunks[k * o.n_chunks + c] = count;
      if (count) atomicAdd(o.counts + k, count);
    }
    __syncthreads();  // cta_sum's shared sums are free again
  }
}

// The persistent grid of a tile kernel: SM count x resident CTAs
// (`resident`, from resident_ctas), no more than there are tiles.
inline unsigned tile_grid(int64_t n_tiles, int64_t resident) {
  return static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
}

}  // namespace aqpc

// Shared pieces of the collect path's two kernels and of the counts on the
// persistent tile loop: the bit-mask layout, the chunking that links the
// mask kernels' per-chunk counts to the compaction's prefix, and the
// persistent tile loops of the count and mask kernels that walk (block,
// chunk) tiles.
//
// Bit mask of one block: ceil(B / 32) uint32 words, bit j of word w is row
// 32w + j; rows >= n_valid and the bits past B in the last word are 0.
// A chunk is kChunkWords consecutive words of one block (8192 rows): every
// mask kernel writes each chunk's hit count. The raw bbox mask runs one CTA
// per (chunk, block) tile, the tiles flattened into the grid's x
// (mask_bits.cu mask_rows); every other mask runs on mask_tiles below, a
// CTA walking tiles of one chunk each. The compaction (compact_bits.cu)
// runs one CTA per (chunk, block) tile, a warp per 32 words, and starts its
// output at the block's offset plus the counts of the chunks before it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

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
// c of block k. Every thread calls it.
__device__ __forceinline__ void finish_chunk(int count, const MaskOut& o, int64_t k, int64_t c) {
  count = cta_sum(count);
  if (threadIdx.x == 0) {
    o.chunks[k * o.n_chunks + c] = count;
    if (count) atomicAdd(o.counts + k, count);
  }
}

// Bits of word w below nv, for any w (0 at or past nv).
__device__ __forceinline__ uint32_t valid_any(int64_t nv, int64_t w) {
  const int64_t left = nv - 32 * w;
  return left >= 32 ? 0xffffffffu : (left <= 0 ? 0u : (1u << left) - 1u);
}

// The CTA's hits of row k, `count` in each thread, into out[k]. Every
// thread calls it. Without work, out is zeroed by the caller and takes one
// atomicAdd. With work, out needs no fill: work[k] is row k's ticket word,
// the CTAs done so far in its high 32 bits and their hits in its low 32, 0
// on entry. Each of the `touching` CTAs of the row adds (1 << 32) + its
// count with one atomicAdd, which orders the sums and the tickets at once;
// the CTA that draws the last ticket stores the row's hits into out[k] and
// sets work[k] back to 0, so work is left as it was found. A row that one
// CTA covers is stored at once.
__device__ __forceinline__ void row_done(int count, int32_t* __restrict__ out,
                                         unsigned long long* __restrict__ work, int64_t k,
                                         int64_t touching) {
  count = cta_sum(count);
  if (threadIdx.x != 0) return;
  if (!work) {
    if (count) atomicAdd(out + k, count);
  } else if (touching == 1) {
    out[k] = count;
  } else {
    const unsigned long long mine = (1ull << 32) | static_cast<unsigned>(count);
    const unsigned long long before = atomicAdd(work + k, mine);
    if ((before >> 32) == static_cast<unsigned long long>(touching - 1)) {
      out[k] = static_cast<int32_t>(static_cast<unsigned>(before + mine));
      work[k] = 0ull;
    }
  }
}

// Persistent grids over (block, chunk) tiles: tile t is chunk t % n_chunks
// of block t / n_chunks, and CTA b walks tiles b, b + gridDim.x, ... (its
// rows never decrease), one mask word a thread. A Tiles test gives Row
// row(k) (nv 0 when no point of row k can match) and uint32_t word(r, w),
// the hit word of points 32w..32w+31 of row r for 32w < r.nv, with the
// bits at or past r.nv 0. A test with kWarpWords makes a warp's 32 words
// together: every lane of a warp whose first word is below r.nv calls
// word(r, w) at once, and the lanes past r.nv get 0. A test may split a
// count's work: Loads, load(r, w, ld), the loads of word w (of its warp,
// with kWarpWords) made only below r.nv, predicated with no branch, and
// int hits(r, w, ld), the thread's share of those hits (0 past r.nv), with
// no shuffle; any thread may call them for any w.

template <class T, class = void>
struct has_loads : std::false_type {};
template <class T>
struct has_loads<T, std::void_t<typename T::Loads>> : std::true_type {};

// The tiles of a count over rows of block_size points, S chunks a tile.
inline int64_t count_row_tiles(int64_t block_size, int S) {
  return (mask_chunks(block_size) + S - 1) / S;
}

// out[k] = the hits of row k, through row_done (work: see there). A count's
// tile is S consecutive chunks of one row (S = 1 but for a test that splits
// its loads), row_tiles = count_row_tiles(B, S) of them a row: tile t is
// chunks S (t % row_tiles) .. + S - 1 of row t / row_tiles, and a thread
// issues the loads of its word in all S chunks before it counts the first,
// so that it keeps S loads in flight. The count stays in registers while
// the row is the same, one row_done per row a CTA touched; the tiles of
// row k are row_tiles consecutive ones, so the CTAs that touch it are
// min(row_tiles, gridDim.x).
template <int S = 1, class Tiles>
__device__ __forceinline__ void count_tiles(const Tiles& f, int32_t* __restrict__ out,
                                            unsigned long long* __restrict__ work,
                                            int64_t row_tiles, int64_t n_tiles) {
  static_assert(has_loads<Tiles>::value || S == 1, "S chunks a tile need split loads");
  const int64_t touching = row_tiles < gridDim.x ? row_tiles : gridDim.x;
  typename Tiles::Row r;
  int64_t row = -1;
  int count = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t k = t / row_tiles;
    if (k != row) {
      if (row >= 0) {
        row_done(count, out, work, row, touching);
        __syncthreads();  // cta_sum's shared sums are free again
      }
      count = 0;
      row = k;
      r = f.row(k);
    }
    const int64_t w = (t - k * row_tiles) * S * kChunkWords + threadIdx.x;
    if constexpr (has_loads<Tiles>::value) {
      typename Tiles::Loads ld[S];
#pragma unroll
      for (int s = 0; s < S; ++s) f.load(r, w + s * kChunkWords, ld[s]);
#pragma unroll
      for (int s = 0; s < S; ++s) count += f.hits(r, w + s * kChunkWords, ld[s]);
    } else if (32 * w < r.nv) {
      count += __popc(f.word(r, w));
    }
  }
  if (row >= 0) row_done(count, out, work, row, touching);
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

// Ordered stream compaction of the collect path's bit masks.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/compact.py
//   masked_collect_multi (lines 86-99) and compact_indices (lines 34-43):
//   jnp.nonzero(mask, size=cap) per block, which XLA lowers to a cumsum and
//   a scatter into a cap-sized buffer; blocks with more hits than the cap
//   were retried at a power-of-two bucket (engine.py:1169-1255).
//
// Here there is no cap and no retry: the host reads the (K,) counts of the
// mask kernel (mask_bits.cu), gives each PARTIAL block (0 < count <
// n_valid) its int64 offset into one output buffer of exactly the sum of
// those counts, and -1 to every other block; this kernel then writes each
// partial block's hit rows as ascending int32 local indices at its offset.
// Blocks with no hits and full blocks need no indices (the engine emits a
// full block as a range).
//
// What bounds it: 4 bytes written per hit, plus one bit read per row.
//
// What the design does about it: one CTA per (chunk of 256 mask words,
// block) tile, the tiles flattened into the grid's x (any K); a warp owns
// 32 consecutive words, lane L word L (a warp's load: 128 consecutive
// bytes). A CTA reads its block's offset first and leaves at once when
// the block is skipped; otherwise the word and the per-chunk counts of
// the chunks before the tile (the mask kernel wrote them) are loaded
// together, and a warp scan of the words' popcounts and one CTA barrier
// over the 8 warps' totals and chunk sums give each word the position of
// its first hit. Then each warp writes its hits in one of two ways, the
// cheaper for its words:
//   - few hits a word (twice the most hits of a word below the number of
//     words with hits): each lane writes its own word's hits, one store
//     instruction for each hit of the busiest lane;
//   - otherwise a word at a time: the warp's words with hits are handed
//     round with __shfl_sync, and lane j writes row 32w + j, if bit j is
//     set, at pos(w) + popc(word & lanemask_lt(j)), so a word's hits land
//     in one run of at most 128 bytes from one store instruction, where
//     lanes writing their own hits spread each store over 32 runs. With
//     hits in all 32 words the loop is unrolled, every word in flight.
// No atomics: the output order is the row order.
//
// compact_bits_gather, the second entry, is the same walk that also gathers
// x, y and z at the rows it writes. Replaces:
// adhoc_queries_pointclouds_tpu/ops/density.py density_candidates_gather
// (lines 598-610): the candidate selection into (K, cap) index buffers,
// then take_along_axis of x, y and z at the clamped indices, with a cap
// retry (parallel/resident.py:446-456). The candidates are already a bit
// mask here (density.cu), and the resident columns live only on the card,
// so the gather rides the compaction, which knows each hit's block and
// row: where a lane stores row r of block k at position p, it also loads
// xs[k B + r], ys[k B + r] and zs[k B + r] and stores them at p. A word's
// hits are one run of at most 32 rows, 128 bytes of each column, so the
// loads coalesce as the index stores do. What bounds it: the mask's bit a
// row, 12 bytes read and 16 written a hit.
#include "block_count.cuh"
#include "collect.cuh"

namespace {

using aqpc::kChunkWords;
using aqpc::kThreads;
using aqpc::kWarps;

constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunkWords == kThreads, "one mask word per thread");

// With kGather, the hit block's three columns and where their gathered
// values go, from the block's first output on.
struct Gather {
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
  int32_t* gx;
  int32_t* gy;
  int32_t* gz;
};

// Row `row` at position p of the block's output: its index and, with
// kGather, its x, y and z.
template <bool kGather>
__device__ __forceinline__ void put(int32_t* __restrict__ dst, const Gather& g, int p,
                                    int32_t row) {
  dst[p] = row;
  if constexpr (kGather) {
    g.gx[p] = g.x[row];
    g.gy[p] = g.y[row];
    g.gz[p] = g.z[row];
  }
}

// The compaction of the CTA's tile; cols: with kGather, the (K, block_size)
// x, y and z columns and the gathered outputs (each as long as out).
template <bool kGather>
__device__ __forceinline__ void compact_tile(const uint32_t* __restrict__ bits,
                                             const int32_t* __restrict__ chunks,
                                             const int64_t* __restrict__ offsets,
                                             int32_t* __restrict__ out, const Gather& cols,
                                             int64_t block_size, int64_t n_words,
                                             int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t k = blockIdx.x / n_chunks;
  const int64_t c = blockIdx.x - k * n_chunks;
  const int64_t w = c * kChunkWords + threadIdx.x;
  const int64_t base = offsets[k];
  if (base < 0) return;  // the whole CTA leaves, having read nothing else
  // both loads before either is used
  const uint32_t word = w < n_words ? __ldcs(bits + k * n_words + w) : 0u;
  int part = 0;  // this thread's share of the hits of the chunks before c
  for (int64_t j = threadIdx.x; j < c; j += kThreads) part += chunks[k * n_chunks + j];

  const int n = __popc(word);
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  __shared__ int2 sums[kWarps];  // (the warp's hits, its share of the chunks before c)
  if (lane == 31) sums[warp] = make_int2(incl, part);
  __syncthreads();
  int before = 0;  // hits of the warps before this one in the tile
  int prior = 0;   // hits of the chunks before c
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int2 s = sums[v];
    before += v < warp ? s.x : 0;
    prior += s.y;
  }
  const int at = before + incl - n;  // the word's first hit within the tile
  int32_t* dst = out + base + prior;
  Gather g{};
  if constexpr (kGather) {
    const int64_t row_at = k * block_size;
    const int64_t out_at = base + prior;
    g = Gather{cols.x + row_at, cols.y + row_at, cols.z + row_at,
               cols.gx + out_at, cols.gy + out_at, cols.gz + out_at};
  }
  const int32_t row0 = static_cast<int32_t>(32 * (w - lane));  // the warp's first row
  const uint32_t busy = __ballot_sync(kFull, word != 0);  // the warp's words with hits
  if (2 * __reduce_max_sync(kFull, n) < __popc(busy)) {
    // few hits a word: each lane writes its own word's hits, one store
    // instruction for each hit of the busiest lane
    int p = at;
    const int32_t row = row0 + 32 * lane;
    for (uint32_t v = word; v; v &= v - 1) put<kGather>(dst, g, p++, row + __ffs(v) - 1);
    return;
  }
  const uint32_t below = (1u << lane) - 1u;
  if (busy == kFull) {  // every word has hits: no walk, every word in flight
#pragma unroll
    for (int src = 0; src < 32; ++src) {
      const uint32_t v = __shfl_sync(kFull, word, src);
      const int p = __shfl_sync(kFull, at, src);
      if ((v >> lane) & 1u) put<kGather>(dst, g, p + __popc(v & below), row0 + 32 * src + lane);
    }
    return;
  }
  for (uint32_t todo = busy; todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const uint32_t v = __shfl_sync(kFull, word, src);
    const int p = __shfl_sync(kFull, at, src);
    if ((v >> lane) & 1u) put<kGather>(dst, g, p + __popc(v & below), row0 + 32 * src + lane);
  }
}

__global__ void __launch_bounds__(kThreads)
compact_bits_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ chunks,
                    const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                    int64_t n_words, int64_t n_chunks) {
  compact_tile<false>(bits, chunks, offsets, out, Gather{}, 0, n_words, n_chunks);
}

__global__ void __launch_bounds__(kThreads)
compact_bits_gather_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ chunks,
                           const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                           Gather cols, int64_t block_size, int64_t n_words, int64_t n_chunks) {
  compact_tile<true>(bits, chunks, offsets, out, cols, block_size, n_words, n_chunks);
}

}  // namespace

// bits: (K, ceil(B/32)) uint32 masks; chunks: (K, ceil(B/8192)) int32
// per-chunk hit counts, both from a mask_bits.cu entry; offsets: (K,) int64
// output offset of each block, -1 to skip it; out: int32, long enough for
// every block not skipped. Returns cudaGetLastError().
extern "C" int aqpc_compact_bits(const void* bits, const void* chunks, const void* offsets,
                                 void* out, int64_t k_blocks, int64_t block_size,
                                 void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t n_chunks = aqpc::mask_chunks(block_size);
  if (k_blocks > aqpc::kMaxGridX / n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  compact_bits_kernel<<<static_cast<unsigned>(n_chunks * k_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(chunks),
      static_cast<const int64_t*>(offsets), static_cast<int32_t*>(out),
      aqpc::mask_words(block_size), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// compact_bits with x, y and z gathered: xs, ys, zs (K, block_size) int32
// columns; gx, gy, gz int32, as long as out, take each written row's
// values at the row's position. Returns cudaGetLastError().
extern "C" int aqpc_compact_bits_gather(const void* bits, const void* chunks,
                                        const void* offsets, const void* xs, const void* ys,
                                        const void* zs, void* out, void* gx, void* gy, void* gz,
                                        int64_t k_blocks, int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t n_chunks = aqpc::mask_chunks(block_size);
  if (k_blocks > aqpc::kMaxGridX / n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  const Gather cols{static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
                    static_cast<const int32_t*>(zs), static_cast<int32_t*>(gx),
                    static_cast<int32_t*>(gy), static_cast<int32_t*>(gz)};
  compact_bits_gather_kernel<<<static_cast<unsigned>(n_chunks * k_blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(chunks),
      static_cast<const int64_t*>(offsets), static_cast<int32_t*>(out), cols, block_size,
      aqpc::mask_words(block_size), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

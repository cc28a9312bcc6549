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
// block), one word per thread. The CTA first sums the per-chunk counts of
// the chunks before its own (the mask kernel wrote them), then an
// exclusive scan of the words' popcounts (warp shuffles, then the 8 warp
// totals) gives each thread the position of its word's first hit; the
// thread writes its word's set bits in ascending order. No atomics: the
// output order is the row order.
#include "block_count.cuh"
#include "collect.cuh"

namespace {

using aqpc::kChunkWords;
using aqpc::kThreads;

static_assert(kChunkWords == kThreads, "one mask word per thread");

__global__ void __launch_bounds__(kThreads)
compact_bits_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ chunks,
                    const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                    int64_t n_words, int64_t n_chunks) {
  const int64_t k = blockIdx.y;
  const int64_t base = offsets[k];
  if (base < 0) return;  // the whole CTA leaves: no barrier is skipped
  const int64_t c = blockIdx.x;
  int part = 0;
  for (int64_t j = threadIdx.x; j < c; j += kThreads) part += chunks[k * n_chunks + j];
  int before;  // hits of the chunks before this one: the scan's total
  aqpc::cta_exclusive_scan(part, &before);
  const int64_t w = c * kChunkWords + threadIdx.x;
  uint32_t word = w < n_words ? bits[k * n_words + w] : 0u;
  int hits;
  const int at = aqpc::cta_exclusive_scan(__popc(word), &hits);
  int64_t pos = base + before + at;
  const int32_t row0 = static_cast<int32_t>(32 * w);
  while (word) {
    out[pos++] = row0 + __ffs(word) - 1;
    word &= word - 1;
  }
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
  if (k_blocks > aqpc::kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = aqpc::mask_chunks(block_size);
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(k_blocks));
  compact_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(chunks),
      static_cast<const int64_t*>(offsets), static_cast<int32_t*>(out),
      aqpc::mask_words(block_size), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

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
// row: row r of block k at position p takes xs[k B + r], ys[k B + r] and
// zs[k B + r] to p.
//
// What bounds it: the mask's bit a row, 16 bytes written a hit, and the
// columns' 32-byte sectors that the hits touch: the card reads a sector
// whole, so a span of 8 rows costs 32 bytes of each column whether one of
// its rows is a hit or all eight are. With hits at random, a share s of
// the rows touches 1 - (1 - s)^8 of the sectors: 66 % at s = 1/8, 90 % at
// 1/4, so from about 1/8 on a tile reads nearly all of its 12 bytes a row.
//
// What the design does about it. A CTA decides for its tile (8192 rows)
// at once, after the compaction's scan:
//   - dense (kDenseHits = 1024 hits or more, 1/8 of its rows, where the
//     sector rule makes the whole span cheap anyway; the columns and
//     outputs 16-byte aligned and B % 4 == 0): the tile's words and the
//     positions of their first hits go to shared memory, and the tile goes
//     in 64 groups of 128 rows, warp w taking groups w, w + 8, ..., so that
//     each round of the CTA reads 1024 consecutive rows of each column and
//     writes one run of each output. Lane j holds rows 4j..4j+3 of its
//     group, a nibble of one word, and reads them with one streaming
//     16-byte load of each column (__ldcs of int4, skipped where its
//     nibble has no hit). It puts its hits, index and x, y, z, into the
//     warp's stage in shared memory at their place in the group's run, the
//     run shifted by the output's misalignment (0-3 entries), and issues
//     the loads of the warp's group after next: two groups' loads are in
//     flight while the warp writes the run of each of the four outputs as
//     16-byte stores, one a lane, and at most 3 entries at either end one
//     at a time.
//   - sparse (fewer hits; or the columns unaligned): each warp the walk
//     above over its own 32 words, its column loads kept apart from its
//     stores: a lane issues the x, y, z loads of kBatch hits (its own
//     word's, or the walk's next kBatch words') together, then stores
//     them. The Gather pointers are __restrict__, and no store comes
//     between the loads of a batch.
// compact_bits itself is unchanged by this: it stores indices only.
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
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ y;
  const int32_t* __restrict__ z;
  int32_t* __restrict__ gx;
  int32_t* __restrict__ gy;
  int32_t* __restrict__ gz;
};

constexpr int kBatch = 4;          // hits a lane loads before it stores, sparse
constexpr int kDenseHits = 1024;   // a tile's hits, of its 8192 rows, from which it is dense
constexpr int kGroupWords = 4;     // a dense group: 4 words, 128 rows, an int4 of a column a lane
constexpr int kGroups = kChunkWords / kGroupWords;  // of a tile
constexpr int kRounds = kGroups / kWarps;           // groups a warp takes
constexpr int kStage = 32 * kGroupWords + 4;  // a group's hits, shifted by up to 3 entries

// Up to kBatch hits of a lane, bit i of `valid` for hit i at row row[i]
// and output position p[i]: every column load before any store.
__device__ __forceinline__ void put_batch(const Gather& g, int32_t* __restrict__ dst,
                                          const int (&p)[kBatch], const int32_t (&row)[kBatch],
                                          unsigned valid) {
  int32_t vx[kBatch], vy[kBatch], vz[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if ((valid >> i) & 1u) {
      vx[i] = __ldcs(g.x + row[i]);
      vy[i] = __ldcs(g.y + row[i]);
      vz[i] = __ldcs(g.z + row[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if ((valid >> i) & 1u) {
      dst[p[i]] = row[i];
      g.gx[p[i]] = vx[i];
      g.gy[p[i]] = vy[i];
      g.gz[p[i]] = vz[i];
    }
  }
}

__device__ __forceinline__ int32_t lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The dense tile (see the note at the top): its 8192 rows from row0 in
// kGroups groups of 128, warp w taking groups w, w + kWarps, ... (a round
// of the CTA reads 1024 consecutive rows of each column). dst_at: dst's
// position in the outputs (for their alignment); words, ats: the tile's
// mask words and the tile position of each word's first hit, hits: the
// tile's; stage: the warp's [4][kStage] entries.
__device__ __forceinline__ void gather_dense(const Gather& g, int32_t* __restrict__ dst,
                                             int64_t dst_at, const uint32_t* __restrict__ words,
                                             const int* __restrict__ ats, int hits, int32_t row0,
                                             int lane, int warp,
                                             int32_t (*__restrict__ stage)[kStage]) {
  const int sub = lane & 7;  // the lane's nibble of its word
  const uint32_t lower = (1u << (4 * sub)) - 1u;
  const int4* __restrict__ xs = reinterpret_cast<const int4*>(g.x + row0);
  const int4* __restrict__ ys = reinterpret_cast<const int4*>(g.y + row0);
  const int4* __restrict__ zs = reinterpret_cast<const int4*>(g.z + row0);
  int32_t* const outs[4] = {dst, g.gx, g.gy, g.gz};
  // the lane's word of group grp (v) and of the warp's next group (v1), and
  // their columns' int4s (c, d), each loaded where the lane's nibble has a
  // hit: two groups' loads in flight
  const int mine_word = lane >> 3;
  uint32_t v = words[kGroupWords * warp + mine_word];
  uint32_t v1 = words[kGroupWords * (warp + kWarps) + mine_word];
  int4 c[3] = {}, d[3] = {};
  const auto load = [&](int grp, uint32_t w, int4 (&to)[3]) {
    if ((w >> (4 * sub)) & 0xfu) {
      const int q = 32 * grp + lane;
      to[0] = __ldcs(xs + q);
      to[1] = __ldcs(ys + q);
      to[2] = __ldcs(zs + q);
    }
  };
  load(warp, v, c);
  load(warp + kWarps, v1, d);
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    const int grp = kWarps * round + warp;
    const int wi = kGroupWords * grp + mine_word;  // the lane's word
    const int first = ats[kGroupWords * grp];      // the group's run
    const int past = grp + 1 < kGroups ? ats[kGroupWords * (grp + 1)] : hits;
    const int mine = ats[wi] + __popc(v & lower);
    const int shift = static_cast<int>((dst_at + first) & 3);  // stage s is output first - shift + s
    const uint32_t nib = (v >> (4 * sub)) & 0xfu;
    const int32_t row = row0 + 4 * (32 * grp + lane);
    int s = shift + mine - first;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((nib >> i) & 1u) {
        stage[0][s] = row + i;
        stage[1][s] = lane_of(c[0], i);
        stage[2][s] = lane_of(c[1], i);
        stage[3][s] = lane_of(c[2], i);
        ++s;
      }
    }
    // c takes the next group's; the one after goes into d, in flight (with
    // the next) while this group is written
    v = v1;
#pragma unroll
    for (int j = 0; j < 3; ++j) c[j] = d[j];
    if (round + 2 < kRounds) {
      v1 = words[kGroupWords * (grp + 2 * kWarps) + mine_word];
      load(grp + 2 * kWarps, v1, d);
    }
    __syncwarp();
    // stage [shift, end) to the outputs: whole int4s at s % 4 == 0, and at
    // most 3 entries before the first and after the last
    const int end = shift + past - first;
    const int m0 = (shift + 3) >> 2, m1 = end >> 2;
    const int head_end = min(4 * m0, end), tail_at = max(4 * m1, 4 * m0);
    const int one = lane < 4 ? shift + lane : tail_at + lane - 4;
    const bool put_one = lane < 4 ? one < head_end : lane < 8 && one < end;
    const int at0 = first - shift;  // the output position of stage entry 0
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (m0 + lane < m1) {
        *reinterpret_cast<int4*>(outs[o] + at0 + 4 * (m0 + lane)) =
            *reinterpret_cast<const int4*>(&stage[o][4 * (m0 + lane)]);
      }
      if (put_one) outs[o][at0 + one] = stage[o][one];
    }
    __syncwarp();
  }
}

// The sparse gather of a warp (see the note at the top): the walk of the
// compaction below, kBatch hits' loads of a lane before their stores.
__device__ __forceinline__ void gather_sparse(const Gather& g, int32_t* __restrict__ dst,
                                              uint32_t word, int at, int n, uint32_t busy,
                                              int32_t row0, int lane) {
  if (2 * __reduce_max_sync(kFull, n) < __popc(busy)) {
    // few hits a word: each lane its own word's hits, kBatch at a time
    int p = at;
    const int32_t row = row0 + 32 * lane;
    for (uint32_t v = word; v;) {
      int q[kBatch];
      int32_t r[kBatch];
      unsigned valid = 0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        q[i] = p + i;
        r[i] = row + __ffs(v) - 1;
        if (v) valid |= 1u << i;
        v &= v - 1;
      }
      put_batch(g, dst, q, r, valid);
      p += kBatch;
    }
    return;
  }
  // a word at a time, kBatch words of the walk a batch: lane j takes row
  // 32w + j, if bit j is set, to pos(w) + popc(word & lanemask_lt(j))
  const uint32_t below = (1u << lane) - 1u;
  for (uint32_t todo = busy; todo;) {
    int q[kBatch];
    int32_t r[kBatch];
    unsigned valid = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {  // todo is the warp's: every lane takes the same words
      const bool live = todo != 0;
      const int src = live ? __ffs(todo) - 1 : 0;
      todo &= todo - 1;
      const uint32_t v = __shfl_sync(kFull, word, src);
      q[i] = __shfl_sync(kFull, at, src) + __popc(v & below);
      r[i] = row0 + 32 * src + lane;
      if (live && ((v >> lane) & 1u)) valid |= 1u << i;
    }
    put_batch(g, dst, q, r, valid);
  }
}

// The dense gather's shared memory: the tile's words and their first hits'
// positions, and each warp's stage.
struct DenseShared {
  uint32_t words[kThreads];
  int ats[kThreads];
  alignas(16) int32_t stage[kWarps][4][kStage];
};

// The compaction of the CTA's tile; cols: with kGather, the (K, block_size)
// x, y and z columns and the gathered outputs (each as long as out), vec:
// whether they are 16-byte aligned and B % 4 == 0 (the dense gather's
// int4s); dense: with kGather, the CTA's DenseShared.
template <bool kGather>
__device__ __forceinline__ void compact_tile(const uint32_t* __restrict__ bits,
                                             const int32_t* __restrict__ chunks,
                                             const int64_t* __restrict__ offsets,
                                             int32_t* __restrict__ out, const Gather& cols,
                                             int64_t block_size, bool vec, int64_t n_words,
                                             int64_t n_chunks, DenseShared* dense) {
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
  int hits = 0;    // the tile's
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int2 s = sums[v];
    before += v < warp ? s.x : 0;
    prior += s.y;
    hits += s.x;
  }
  const int at = before + incl - n;  // the word's first hit within the tile
  int32_t* dst = out + base + prior;
  const int32_t row0 = static_cast<int32_t>(32 * (w - lane));  // the warp's first row
  const uint32_t busy = __ballot_sync(kFull, word != 0);  // the warp's words with hits
  if constexpr (kGather) {
    const int64_t row_at = k * block_size;
    const int64_t out_at = base + prior;
    const Gather g{cols.x + row_at, cols.y + row_at, cols.z + row_at,
                   cols.gx + out_at, cols.gy + out_at, cols.gz + out_at};
    if (vec && hits >= kDenseHits) {  // the whole CTA, through shared memory
      dense->words[threadIdx.x] = word;
      dense->ats[threadIdx.x] = at;
      __syncthreads();
      gather_dense(g, dst, out_at, dense->words, dense->ats, hits,
                   static_cast<int32_t>(32 * (w - threadIdx.x)), lane, warp, dense->stage[warp]);
    } else {
      gather_sparse(g, dst, word, at, n, busy, row0, lane);
    }
    return;
  }
  if (2 * __reduce_max_sync(kFull, n) < __popc(busy)) {
    // few hits a word: each lane writes its own word's hits, one store
    // instruction for each hit of the busiest lane
    int p = at;
    const int32_t row = row0 + 32 * lane;
    for (uint32_t v = word; v; v &= v - 1) dst[p++] = row + __ffs(v) - 1;
    return;
  }
  const uint32_t below = (1u << lane) - 1u;
  if (busy == kFull) {  // every word has hits: no walk, every word in flight
#pragma unroll
    for (int src = 0; src < 32; ++src) {
      const uint32_t v = __shfl_sync(kFull, word, src);
      const int p = __shfl_sync(kFull, at, src);
      if ((v >> lane) & 1u) dst[p + __popc(v & below)] = row0 + 32 * src + lane;
    }
    return;
  }
  for (uint32_t todo = busy; todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const uint32_t v = __shfl_sync(kFull, word, src);
    const int p = __shfl_sync(kFull, at, src);
    if ((v >> lane) & 1u) dst[p + __popc(v & below)] = row0 + 32 * src + lane;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_bits_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ chunks,
                    const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                    int64_t n_words, int64_t n_chunks) {
  compact_tile<false>(bits, chunks, offsets, out, Gather{}, 0, false, n_words, n_chunks,
                      nullptr);
}

__global__ void __launch_bounds__(kThreads)
compact_bits_gather_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ chunks,
                           const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                           Gather cols, int64_t block_size, bool vec, int64_t n_words,
                           int64_t n_chunks) {
  __shared__ DenseShared dense;
  compact_tile<true>(bits, chunks, offsets, out, cols, block_size, vec, n_words, n_chunks,
                     &dense);
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
  // the dense gather's 16-byte loads and stores: every row of every block
  // and every output on a 16-byte boundary where its position is
  const bool vec = block_size % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(ys) |
                     reinterpret_cast<uintptr_t>(zs) | reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(gy) |
                     reinterpret_cast<uintptr_t>(gz)) & 15u) == 0;
  compact_bits_gather_kernel<<<static_cast<unsigned>(n_chunks * k_blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(chunks),
      static_cast<const int64_t*>(offsets), static_cast<int32_t*>(out), cols, block_size, vec,
      aqpc::mask_words(block_size), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

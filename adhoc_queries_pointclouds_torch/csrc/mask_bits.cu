// Predicate -> bit mask for the collect path: one entry per collect kind.
//
// Replaces the mask half of adhoc_queries_pointclouds_tpu/parallel/mesh.py
// _collect_fn (lines 229-291), which XLA fuses with the compaction:
//   bbox          bbox_mask_jnp_multi (ops/predicate.py:261-268)
//   bbox_packed   unpack_bits_jnp + bbox_mask_packed_jnp_multi (:480-512)
//   class         class_mask_jnp_multi (:247-249), u8 rows
//   class_dict    class_mask_dict_jnp_multi (:604-606)
//   time          time_mask_jnp_multi (:235-240)
//   time_packed   time_mask_packed_jnp_multi (:537-540)
// and the per-block counts of masked_collect_multi (ops/compact.py:86-99).
//
// Each entry writes, for K blocks of B rows:
//   bits   (K, ceil(B/32)) uint32, in the layout of collect.cuh: bit j of
//          word w is row 32w + j; rows >= n_valid and tail bits are 0;
//   counts (K,) int32 true hit counts (zeroed by the caller);
//   chunks (K, ceil(B / 8192)) int32 hits per chunk of 256 words, the
//          prefix that compact_bits.cu starts each CTA from.
// The raw predicates are the count kernels' own (predicates.cuh); the
// packed ones are bbox_planes.cuh's and time_planes.cuh's.
//
// What bounds it: device-memory reads of the predicate columns, as in the
// count kernels, plus one bit per row written.
//
// What the design does about it: the raw bbox entry alone runs one CTA
// per (chunk, block) tile, the tiles flattened into the grid's x (mask_rows,
// any K); each warp builds one mask word per
// pass, lane j testing row 32w + j (neighbouring lanes on neighbouring
// addresses) and __ballot_sync gathering the 32 results; counts stay in
// registers and each CTA writes its chunk count and adds it to counts[k]
// with one integer atomic. Every other entry runs on the persistent tile
// loop (collect.cuh mask_tiles: SM count x resident CTAs walk the (chunk,
// block) tiles, any K): the packed bbox and time entries and the
// dictionary entry compare in the packed domain (bbox_planes.cuh,
// time_planes.cuh; the dictionary test is one axis of the box test at lo =
// hi = the target code, DictTiles), a thread making one whole word with no
// shuffle; the raw time and class entries make a warp's 32 words together
// from streaming loads (__ldcs: evict first, the words are read once), all
// of a lane's loads in flight before the first compare: 16-byte loads,
// four points a lane and three shuffles a word for time (TimeRawTiles);
// 16 points a lane tested at once with __vcmpeq4 and two lanes paired into
// a word by one shuffle for class (class_tiles.cuh ClassRawTiles, whose
// body the u8 and word class counts share; rows off 16-byte boundaries
// take realigned 4-byte loads). A row that no point can
// match (an empty box or range, a dictionary miss, a class target outside
// 0..255) reads nothing.
#include "bbox_planes.cuh"
#include "block_count.cuh"
#include "class_tiles.cuh"
#include "collect.cuh"
#include "predicates.cuh"
#include "time_planes.cuh"

namespace {

using aqpc::ClassRawTiles;
using aqpc::kChunkWords;
using aqpc::kThreads;
using aqpc::kWarps;
using aqpc::MaskOut;
using aqpc::finish_chunk;
using aqpc::Planes;
using aqpc::valid_any;

constexpr unsigned kFull = 0xffffffffu;

// Raw columns, chunk c of row k: lane j of a warp tests row 32w + j;
// pred(i) reads row i.
template <class RowPred>
__device__ __forceinline__ void mask_rows(const RowPred& pred, int64_t nv, const MaskOut& o,
                                          int64_t k, int64_t c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = c * kChunkWords;
  const int64_t w1 = w0 + kChunkWords < o.n_words ? w0 + kChunkWords : o.n_words;
  uint32_t* out = o.bits + k * o.n_words;
  int count = 0;
  for (int64_t w = w0 + warp; w < w1; w += kWarps) {
    const int64_t i = 32 * w + lane;
    const unsigned word = __ballot_sync(kFull, i < nv && pred(i));
    if (lane == 0) {
      out[w] = word;
      count += __popc(word);
    }
  }
  finish_chunk(count, o, k, c);
}

struct BboxRows {
  const int32_t *x, *y, *z;
  int b[6];
  __device__ bool operator()(int64_t i) const { return aqpc::in_box(x[i], y[i], z[i], b); }
};

// One block row of the raw GPS-time test; nv is 0 when the range is empty.
struct TimeRawRow {
  const int32_t* h;
  const int32_t* l;
  int q[4];
  int64_t nv;
};

// The hit bits of four consecutive points (bit i: point i of the four).
__device__ __forceinline__ uint32_t time_nibble(const int4& h, const int4& l, const int (&q)[4]) {
  using aqpc::in_time_range;
  return static_cast<uint32_t>(in_time_range(h.x, l.x, q) | in_time_range(h.y, l.y, q) << 1 |
                               in_time_range(h.z, l.z, q) << 2 | in_time_range(h.w, l.w, q) << 3);
}

// The raw GPS-time test as the tile loops of collect.cuh take it: a warp
// makes its 32 words together (kWarpWords), lane L word w0 + L. Wide (B %
// 4 == 0, rows on 16-byte boundaries): lane L tests points 4L..4L+3 of
// each 128-point span of the warp's 1024 from one int4 of th and one of tl
// (a warp's load: 512 consecutive bytes), eight spans' loads in flight
// before the first compare; eight lanes OR their 4-bit results into a word
// with three __shfl_xor_sync, and one __shfl_sync hands each lane its
// word. Otherwise lane L tests point L of each of the 32 words (a warp's
// load: 128 consecutive bytes), all 64 loads in flight, and __ballot_sync
// makes each word. Every load is streaming (__ldcs: evict first, the words
// are read once). A load is made only below nv, so nothing past the row is
// read. (A thread a word, eight int4 of th and eight of tl, was slower: a
// warp's load then touches 32 lines of 128 bytes; so was the tile staged
// in shared memory by cp.async at 3 CTAs an SM: PERF.md section 6.)
template <bool Wide>
struct TimeRawTiles {
  using Row = TimeRawRow;
  static constexpr int kMinCtas = 2;  // CTAs an SM the body is built for
  static constexpr bool kWarpWords = true;
  const int32_t* ths;
  const int32_t* tls;
  const int32_t* qs;
  const int32_t* nvs;
  int64_t block_size;
  __device__ __forceinline__ Row row(int64_t k) const {
    Row r;
    r.h = ths + k * block_size;
    r.l = tls + k * block_size;
#pragma unroll
    for (int j = 0; j < 4; ++j) r.q[j] = qs[4 * k + j];
    // [q0, q1) holds a point only when q0 < q1 lexicographically
    const bool some = r.q[0] < r.q[2] || (r.q[0] == r.q[2] && r.q[1] < r.q[3]);
    r.nv = some ? aqpc::clamp_valid(nvs[k], block_size) : 0;
    return r;
  }
  __device__ __forceinline__ uint32_t word(const Row& r, int64_t w) const {
    const int lane = threadIdx.x & 31;
    const int64_t p0 = 32 * (w - lane);  // the warp's first point
    uint32_t mine = 0;
    if (Wide) {
      int4 h[8], l[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int64_t i = p0 + 128 * s + 4 * lane;
        const bool in = i < r.nv;
        h[s] = in ? __ldcs(reinterpret_cast<const int4*>(r.h + i)) : make_int4(0, 0, 0, 0);
        l[s] = in ? __ldcs(reinterpret_cast<const int4*>(r.l + i)) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t v = time_nibble(h[s], l[s], r.q) << (4 * (lane & 7));
        v |= __shfl_xor_sync(kFull, v, 1);
        v |= __shfl_xor_sync(kFull, v, 2);
        v |= __shfl_xor_sync(kFull, v, 4);
        // lanes 8g..8g+7 now hold word 4s + g of the warp
        const uint32_t got = __shfl_sync(kFull, v, 8 * (lane & 3));
        if ((lane >> 2) == s) mine = got;
      }
    } else {
      int h[32], l[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int64_t i = p0 + 32 * j + lane;
        h[j] = i < r.nv ? __ldcs(r.h + i) : 0;
        l[j] = i < r.nv ? __ldcs(r.l + i) : 0;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t v = __ballot_sync(kFull, aqpc::in_time_range(h[j], l[j], r.q));
        if (lane == j) mine = v;
      }
    }
    return mine & valid_any(r.nv, w);
  }
};

__global__ void __launch_bounds__(kThreads)
mask_bbox_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                 const int32_t* __restrict__ zs, const int32_t* __restrict__ bounds,
                 const int32_t* __restrict__ nvs, MaskOut o, int64_t block_size) {
  const int64_t k = blockIdx.x / o.n_chunks;
  BboxRows p{xs + k * block_size, ys + k * block_size, zs + k * block_size, {}};
#pragma unroll
  for (int j = 0; j < 6; ++j) p.b[j] = bounds[k * 6 + j];
  mask_rows(p, aqpc::clamp_valid(nvs[k], block_size), o, k, blockIdx.x - k * o.n_chunks);
}

// One thread per mask word of a tile (chunk c of block k); the CTA walks
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the packed bbox and time
// entries, the dictionary entry and the raw time and class entries, Tiles
// a BoxTiles, TimeTiles, DictTiles, TimeRawTiles or ClassRawTiles.
template <class Tiles>
__global__ void __launch_bounds__(kThreads, Tiles::kMinCtas)
mask_packed_kernel(Tiles f, MaskOut o, int64_t k_blocks) {
  aqpc::mask_tiles(f, o, k_blocks);
}

// The outputs of one entry.
MaskOut mask_out(int64_t block_size, void* bits, void* counts, void* chunks) {
  return MaskOut{static_cast<uint32_t*>(bits), static_cast<int32_t*>(counts),
                 static_cast<int32_t*>(chunks), aqpc::mask_words(block_size),
                 aqpc::mask_chunks(block_size)};
}

int done() { return static_cast<int>(cudaGetLastError()); }
int refused() { return static_cast<int>(cudaErrorInvalidValue); }

// A tile-loop entry's persistent grid: SM count x resident CTAs, no more
// than there are tiles.
template <class Tiles>
int launch_packed(const Tiles& f, const MaskOut& o, int64_t k_blocks, void* stream) {
  static aqpc::ResidentCtas resident_of;
  const int64_t resident = resident_of(mask_packed_kernel<Tiles>);
  mask_packed_kernel<<<aqpc::tile_grid(o.n_chunks * k_blocks, resident), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(f, o, k_blocks);
  return done();
}

}  // namespace

// Every entry: (K, ...) inputs, then bits (K, ceil(B/32)) uint32, counts
// (K,) int32 zeroed by the caller, chunks (K, ceil(B/8192)) int32, then K
// and B (and widths), then the stream. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernels refuse.

// The rows per chunk the caller must size `chunks` by, in words of 32 rows.
extern "C" int64_t aqpc_mask_chunk_words() { return kChunkWords; }

// xs, ys, zs: (K, B) int32; bounds: (K, 6) int32 [lo, hi]; nvs: (K,) int32.
extern "C" int aqpc_mask_bbox(const void* xs, const void* ys, const void* zs,
                              const void* bounds, const void* nvs, void* bits, void* counts,
                              void* chunks, int64_t k_blocks, int64_t block_size,
                              void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  if (k_blocks > aqpc::kMaxGridX / o.n_chunks) return refused();  // one CTA a (chunk, block)
  const auto grid = static_cast<unsigned>(k_blocks * o.n_chunks);
  mask_bbox_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(zs), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(nvs), o, block_size);
  return done();
}

// xp, yp, zp: (K, row width) u8 plane stacks at kx, ky, kz bits in [0, 32];
// bounds: (K, 6) int32 residual-space [lo, hi]; nvs: (K,) int32.
extern "C" int aqpc_mask_bbox_packed(const void* xp, const void* yp, const void* zp,
                                     const void* bounds, const void* nvs, void* bits,
                                     void* counts, void* chunks, int64_t k_blocks,
                                     int64_t block_size, int64_t kx, int64_t ky, int64_t kz,
                                     void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  if (!aqpc::width_ok(kx, 32, block_size) || !aqpc::width_ok(ky, 32, block_size) ||
      !aqpc::width_ok(kz, 32, block_size))
    return refused();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  const Planes ax = aqpc::make_planes(xp, kx, block_size);
  const Planes ay = aqpc::make_planes(yp, ky, block_size);
  const Planes az = aqpc::make_planes(zp, kz, block_size);
  const auto* b = static_cast<const int32_t*>(bounds);
  const auto* nv = static_cast<const int32_t*>(nvs);
  return aqpc::planes_wide(block_size, xp, yp, zp)
             ? launch_packed(aqpc::BoxTiles<true>{ax, ay, az, b, nv, block_size}, o, k_blocks,
                             stream)
             : launch_packed(aqpc::BoxTiles<false>{ax, ay, az, b, nv, block_size}, o, k_blocks,
                             stream);
}

// cls: (K, B) u8; targets, nvs: (K,) int32.
extern "C" int aqpc_mask_class(const void* cls, const void* targets, const void* nvs,
                               void* bits, void* counts, void* chunks, int64_t k_blocks,
                               int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  const auto* c = static_cast<const uint8_t*>(cls);
  const auto* t = static_cast<const int32_t*>(targets);
  const auto* nv = static_cast<const int32_t*>(nvs);
  if (block_size % 16 != 0 || reinterpret_cast<uintptr_t>(cls) % 16 != 0)
    return launch_packed(ClassRawTiles<false>{c, t, nv, block_size, false}, o, k_blocks,
                         stream);
  return launch_packed(ClassRawTiles<true>{c, t, nv, block_size, false}, o, k_blocks, stream);
}

// cp: (K, row width) u8 code planes at k_bits in [0, 8]; targets: (K,)
// int32 target codes (len(dict) on a miss); nvs: (K,) int32.
extern "C" int aqpc_mask_class_dict(const void* cp, const void* targets, const void* nvs,
                                    void* bits, void* counts, void* chunks, int64_t k_blocks,
                                    int64_t block_size, int64_t k_bits, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  if (!aqpc::width_ok(k_bits, 8, block_size)) return refused();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  const Planes p = aqpc::make_planes(cp, k_bits, block_size);
  const auto* t = static_cast<const int32_t*>(targets);
  const auto* nv = static_cast<const int32_t*>(nvs);
  return aqpc::with_int<1>(aqpc::planes_wide(block_size, cp), [&](auto wide) {
    return aqpc::with_int<1>(p.nbytes, [&](auto nb) {
      return launch_packed(
          aqpc::DictTiles<decltype(wide)::value != 0, decltype(nb)::value>{p, t, nv, block_size},
          o, k_blocks, stream);
    });
  });
}

// ths, tls: (K, B) int32 encoded hi/lo words; qs: (K, 4) int32; nvs: (K,).
extern "C" int aqpc_mask_time(const void* ths, const void* tls, const void* qs,
                              const void* nvs, void* bits, void* counts, void* chunks,
                              int64_t k_blocks, int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  const auto* h = static_cast<const int32_t*>(ths);
  const auto* l = static_cast<const int32_t*>(tls);
  const auto* q = static_cast<const int32_t*>(qs);
  const auto* nv = static_cast<const int32_t*>(nvs);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ths) | reinterpret_cast<uintptr_t>(tls);
  if (block_size % 4 != 0 || addr % 16 != 0)
    return launch_packed(TimeRawTiles<false>{h, l, q, nv, block_size}, o, k_blocks, stream);
  return launch_packed(TimeRawTiles<true>{h, l, q, nv, block_size}, o, k_blocks, stream);
}

// thp, tlp: (K, row width) u8 plane stacks at k_hi, k_lo bits in [0, 32];
// qs: (K, 4) int32 residual-space ranges; nvs: (K,) int32.
extern "C" int aqpc_mask_time_packed(const void* thp, const void* tlp, const void* qs,
                                     const void* nvs, void* bits, void* counts, void* chunks,
                                     int64_t k_blocks, int64_t block_size, int64_t k_hi,
                                     int64_t k_lo, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  if (!aqpc::width_ok(k_hi, 32, block_size) || !aqpc::width_ok(k_lo, 32, block_size))
    return refused();
  const MaskOut o = mask_out(block_size, bits, counts, chunks);
  return aqpc::with_time_shape(
      aqpc::make_planes(thp, k_hi, block_size), aqpc::make_planes(tlp, k_lo, block_size), qs,
      nvs, block_size, [&](auto tiles) { return launch_packed(tiles, o, k_blocks, stream); });
}

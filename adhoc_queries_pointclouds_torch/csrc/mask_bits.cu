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
// The predicates are the count kernels' own (predicates.cuh).
//
// What bounds it: device-memory reads of the predicate columns, as in the
// count kernels, plus one bit per row written.
//
// What the design does about it: one CTA per (chunk, block). On raw
// columns each warp builds one mask word per pass, lane j testing row
// 32w + j (neighbouring lanes on neighbouring addresses) and __ballot_sync
// gathering the 32 results. On the packed time and dictionary planes the
// unit is the count kernels' 8-point group: lane l rebuilds group 4w' + l
// with aqpc::unpack8, and four lanes OR their 8-bit masks into one word
// with two shuffles, so a warp writes 8 words per pass. Counts stay in
// registers; each CTA writes its chunk count and adds it to counts[k] with
// one integer atomic. The packed bbox entry compares in the packed domain
// (bbox_planes.cuh): a thread makes one whole mask word, with no shuffle,
// and a persistent grid of CTAs walks the (chunk, block) tiles.
#include "bbox_planes.cuh"
#include "block_count.cuh"
#include "collect.cuh"
#include "predicates.cuh"

namespace {

using aqpc::kChunkWords;
using aqpc::kThreads;
using aqpc::kWarps;
using aqpc::Planes;
using aqpc::PlaneRow;

constexpr unsigned kFull = 0xffffffffu;

struct MaskOut {
  uint32_t* bits;
  int32_t* counts;
  int32_t* chunks;
  int64_t n_words;
  int64_t n_chunks;
};

// The chunk's count into chunks[k, c] and counts[k]. Every thread calls it.
__device__ __forceinline__ void finish_chunk(int count, const MaskOut& o) {
  const int64_t k = blockIdx.y;
  count = aqpc::cta_sum(count);
  if (threadIdx.x == 0) {
    o.chunks[k * o.n_chunks + blockIdx.x] = count;
    if (count) atomicAdd(o.counts + k, count);
  }
}

// Raw columns: lane j of a warp tests row 32w + j; pred(i) reads row i.
template <class RowPred>
__device__ __forceinline__ void mask_rows(const RowPred& pred, int64_t nv, const MaskOut& o) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kChunkWords;
  const int64_t w1 = w0 + kChunkWords < o.n_words ? w0 + kChunkWords : o.n_words;
  uint32_t* out = o.bits + static_cast<int64_t>(blockIdx.y) * o.n_words;
  int count = 0;
  for (int64_t w = w0 + warp; w < w1; w += kWarps) {
    const int64_t i = 32 * w + lane;
    const unsigned word = __ballot_sync(kFull, i < nv && pred(i));
    if (lane == 0) {
      out[w] = word;
      count += __popc(word);
    }
  }
  finish_chunk(count, o);
}

// Packed planes: lane l rebuilds the 8 points of group 4*wb + l, so the
// warp covers words wb..wb+7; pred(g, valid) is the group's 8-bit mask.
template <class GroupPred>
__device__ __forceinline__ void mask_groups(const GroupPred& pred, int64_t nv,
                                            const MaskOut& o) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kChunkWords;
  const int64_t w1 = w0 + kChunkWords < o.n_words ? w0 + kChunkWords : o.n_words;
  uint32_t* out = o.bits + static_cast<int64_t>(blockIdx.y) * o.n_words;
  int count = 0;
  for (int64_t wb = w0 + 8 * warp; wb < w1; wb += 8 * kWarps) {
    const int64_t g = 4 * wb + lane;
    const int64_t left = nv - 8 * g;
    const int valid = left >= 8 ? 8 : (left <= 0 ? 0 : static_cast<int>(left));
    const unsigned m = valid ? pred(g, valid) : 0u;
    unsigned word = m << (8 * (lane & 3));
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    const int64_t w = wb + (lane >> 2);
    if ((lane & 3) == 0 && w < w1) {
      out[w] = word;
      count += __popc(word);
    }
  }
  finish_chunk(count, o);
}

struct BboxRows {
  const int32_t *x, *y, *z;
  int b[6];
  __device__ bool operator()(int64_t i) const { return aqpc::in_box(x[i], y[i], z[i], b); }
};

struct ClassRows {
  const uint8_t* c;
  int t;
  __device__ bool operator()(int64_t i) const { return aqpc::class_matches(c[i], t); }
};

struct TimeRows {
  const int32_t *h, *l;
  int q[4];
  __device__ bool operator()(int64_t i) const { return aqpc::in_time_range(h[i], l[i], q); }
};

struct DictGroups {
  PlaneRow c;
  int t;
  int64_t block_size;
  __device__ unsigned operator()(int64_t g, int valid) const {
    return aqpc::dict_mask8(c, t, block_size, g, valid);
  }
};

struct TimeGroups {
  PlaneRow h, l;
  int q[4];
  int64_t block_size;
  __device__ unsigned operator()(int64_t g, int valid) const {
    return aqpc::time_packed_mask8(h, l, q, block_size, g, valid);
  }
};

__global__ void __launch_bounds__(kThreads)
mask_bbox_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                 const int32_t* __restrict__ zs, const int32_t* __restrict__ bounds,
                 const int32_t* __restrict__ nvs, MaskOut o, int64_t block_size) {
  const int64_t k = blockIdx.y;
  BboxRows p{xs + k * block_size, ys + k * block_size, zs + k * block_size, {}};
#pragma unroll
  for (int j = 0; j < 6; ++j) p.b[j] = bounds[k * 6 + j];
  mask_rows(p, aqpc::clamp_valid(nvs[k], block_size), o);
}

__global__ void __launch_bounds__(kThreads)
mask_class_kernel(const uint8_t* __restrict__ cls, const int32_t* __restrict__ targets,
                  const int32_t* __restrict__ nvs, MaskOut o, int64_t block_size) {
  const int64_t k = blockIdx.y;
  mask_rows(ClassRows{cls + k * block_size, targets[k]}, aqpc::clamp_valid(nvs[k], block_size),
            o);
}

__global__ void __launch_bounds__(kThreads)
mask_time_kernel(const int32_t* __restrict__ ths, const int32_t* __restrict__ tls,
                 const int32_t* __restrict__ qs, const int32_t* __restrict__ nvs, MaskOut o,
                 int64_t block_size) {
  const int64_t k = blockIdx.y;
  TimeRows p{ths + k * block_size, tls + k * block_size, {}};
#pragma unroll
  for (int j = 0; j < 4; ++j) p.q[j] = qs[k * 4 + j];
  mask_rows(p, aqpc::clamp_valid(nvs[k], block_size), o);
}

// One thread per mask word of a tile (chunk c of block k); the CTA walks
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <bool Wide>
__global__ void __launch_bounds__(kThreads, 2)
mask_bbox_packed_kernel(Planes ax, Planes ay, Planes az, const int32_t* __restrict__ bounds,
                        const int32_t* __restrict__ nvs, MaskOut o, int64_t k_blocks,
                        int64_t block_size) {
  aqpc::BoxRow r;
  int64_t row = -1;
  const int64_t n_tiles = o.n_chunks * k_blocks;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t k = t / o.n_chunks;
    const int64_t c = t % o.n_chunks;
    if (k != row) {
      row = k;
      r = aqpc::box_row(ax, ay, az, bounds, nvs, k, block_size);
    }
    const int64_t w = c * kChunkWords + threadIdx.x;
    uint32_t word = 0;
    if (w < o.n_words) {
      if (32 * w < r.nv) word = aqpc::box_word<Wide>(r, block_size, w);
      o.bits[k * o.n_words + w] = word;
    }
    const int count = aqpc::cta_sum(__popc(word));
    if (threadIdx.x == 0) {
      o.chunks[k * o.n_chunks + c] = count;
      if (count) atomicAdd(o.counts + k, count);
    }
    __syncthreads();  // cta_sum's shared sums are free again
  }
}

__global__ void __launch_bounds__(kThreads)
mask_class_dict_kernel(Planes cp, const int32_t* __restrict__ targets,
                       const int32_t* __restrict__ nvs, MaskOut o, int64_t block_size) {
  const int64_t k = blockIdx.y;
  mask_groups(DictGroups{aqpc::plane_row(cp, k, block_size), targets[k], block_size},
              aqpc::clamp_valid(nvs[k], block_size), o);
}

__global__ void __launch_bounds__(kThreads)
mask_time_packed_kernel(Planes ph, Planes pl, const int32_t* __restrict__ qs,
                        const int32_t* __restrict__ nvs, MaskOut o, int64_t block_size) {
  const int64_t k = blockIdx.y;
  TimeGroups p{aqpc::plane_row(ph, k, block_size), aqpc::plane_row(pl, k, block_size), {},
               block_size};
#pragma unroll
  for (int j = 0; j < 4; ++j) p.q[j] = qs[k * 4 + j];
  mask_groups(p, aqpc::clamp_valid(nvs[k], block_size), o);
}

// Launch shape and outputs of one entry; false on sizes the kernels refuse.
bool prepare(int64_t k_blocks, int64_t block_size, void* bits, void* counts, void* chunks,
             dim3* grid, MaskOut* o) {
  if (k_blocks > aqpc::kMaxGridY) return false;
  *o = MaskOut{static_cast<uint32_t*>(bits), static_cast<int32_t*>(counts),
               static_cast<int32_t*>(chunks), aqpc::mask_words(block_size),
               aqpc::mask_chunks(block_size)};
  *grid = dim3(static_cast<unsigned>(o->n_chunks), static_cast<unsigned>(k_blocks));
  return true;
}

int done() { return static_cast<int>(cudaGetLastError()); }
int refused() { return static_cast<int>(cudaErrorInvalidValue); }

// The packed bbox entry's persistent grid: SM count x resident CTAs, no
// more than there are tiles.
template <bool Wide>
int launch_bbox_packed(const Planes& ax, const Planes& ay, const Planes& az, const void* bounds,
                       const void* nvs, const MaskOut& o, int64_t k_blocks, int64_t block_size,
                       void* stream) {
  static const int64_t resident = aqpc::resident_ctas(mask_bbox_packed_kernel<Wide>);
  const int64_t n_tiles = o.n_chunks * k_blocks;
  const int64_t grid = n_tiles < resident ? n_tiles : resident;
  mask_bbox_packed_kernel<Wide><<<static_cast<unsigned>(grid), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      ax, ay, az, static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(nvs), o,
      k_blocks, block_size);
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
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
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
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
  const Planes ax = aqpc::make_planes(xp, kx, block_size);
  const Planes ay = aqpc::make_planes(yp, ky, block_size);
  const Planes az = aqpc::make_planes(zp, kz, block_size);
  return aqpc::box_planes_wide(xp, yp, zp, block_size)
             ? launch_bbox_packed<true>(ax, ay, az, bounds, nvs, o, k_blocks, block_size, stream)
             : launch_bbox_packed<false>(ax, ay, az, bounds, nvs, o, k_blocks, block_size,
                                         stream);
}

// cls: (K, B) u8; targets, nvs: (K,) int32.
extern "C" int aqpc_mask_class(const void* cls, const void* targets, const void* nvs,
                               void* bits, void* counts, void* chunks, int64_t k_blocks,
                               int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
  mask_class_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cls), static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(nvs), o, block_size);
  return done();
}

// cp: (K, row width) u8 code planes at k_bits in [0, 8]; targets: (K,)
// int32 target codes (len(dict) on a miss); nvs: (K,) int32.
extern "C" int aqpc_mask_class_dict(const void* cp, const void* targets, const void* nvs,
                                    void* bits, void* counts, void* chunks, int64_t k_blocks,
                                    int64_t block_size, int64_t k_bits, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  if (!aqpc::width_ok(k_bits, 8, block_size)) return refused();
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
  mask_class_dict_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aqpc::make_planes(cp, k_bits, block_size), static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(nvs), o, block_size);
  return done();
}

// ths, tls: (K, B) int32 encoded hi/lo words; qs: (K, 4) int32; nvs: (K,).
extern "C" int aqpc_mask_time(const void* ths, const void* tls, const void* qs,
                              const void* nvs, void* bits, void* counts, void* chunks,
                              int64_t k_blocks, int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return done();
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
  mask_time_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ths), static_cast<const int32_t*>(tls),
      static_cast<const int32_t*>(qs), static_cast<const int32_t*>(nvs), o, block_size);
  return done();
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
  dim3 grid;
  MaskOut o;
  if (!prepare(k_blocks, block_size, bits, counts, chunks, &grid, &o)) return refused();
  mask_time_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aqpc::make_planes(thp, k_hi, block_size), aqpc::make_planes(tlp, k_lo, block_size),
      static_cast<const int32_t*>(qs), static_cast<const int32_t*>(nvs), o, block_size);
  return done();
}

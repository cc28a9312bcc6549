// Multi-block GPS-time range counts over the (hi, lo) int32 encoding.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/predicate.py
//   time_mask_jnp_multi / time_count_jnp_multi (lines 235-244), which XLA
//   fuses, reached through parallel/mesh.py sharded_time_count (lines
//   143-162): the raw transport (AQPC_PACK=0);
//   unpack_bits_jnp + time_count_packed_jnp_multi (lines 480-496, 529-534),
//   reached through sharded_time_count_packed (lines 165-190): the default
//   packed transport.
//
// The host encodes each f64 GPS time into an order-preserving (hi, lo)
// int32 pair (encode_f64_sortable), so the half-open range [start, end) is
// two lexicographic compares on signed int32:
//   ge = th > q0 | (th == q0 & tl >= q1),  lt = th < q2 | (th == q2 & tl < q3)
// and out[k] = #{ i < nv[k] : ge & lt } with q = qs[k]. In the packed form
// the hi and lo words are k-bit residuals against per-block bases, and qs
// holds the query words shifted into residual space and saturating-clipped
// to int32 on the host. That clip is exact only under the host packer's
// <= 28-bit width cap, and k = 32 forces base 0; the kernel takes qs as
// given and re-derives neither.
//
// What bounds it: device-memory reads, 8 bytes per valid point raw,
// (k_hi + k_lo) / 8 packed, as long as the packed compare stays cheap:
// rebuilding the two int32 words costs three integer operations per point
// and plane, which for a bit plane (an eighth of a byte) puts the limit on
// the integer pipes.
//
// What the design does about it: the raw kernel fuses both compares and the
// count in one pass with 16-byte int4 loads when the rows are aligned and
// B % 4 == 0 (scalar loads otherwise), one CTA row a block, the rows
// flattened into the grid's x (any K); the plain version materialises about
// six (K, B) bool temporaries; each CTA's count reaches out[k] with one
// integer atomic. The packed kernel rebuilds no word: the lexicographic
// range is one range on the (k_hi + k_lo)-bit number hi:lo, tested as two
// borrow chains that run through lo's planes into hi's, 32 points a word,
// every load of a word started before its first compare (time_planes.cuh).
// The grid is persistent, SM count x resident CTAs, walking tiles of
// kChunkWords words (one word per thread) across all K rows with the count
// in registers and one atomicAdd per row a CTA touched (collect.cuh
// count_tiles). A template body per pair of byte-plane counts (25, each
// with wide and narrow loads) is picked on the host; bit planes are
// runtime. The lighter wide bodies are built for 4 CTAs an SM, the others
// for 2 (TimeTiles::kMinCtas): more warps in flight hide more of the
// latency of each tile's loads, but not at the price of spilling. out is
// zeroed by the caller: that launch is the floor the (0, 0) width shows.
#include "block_count.cuh"
#include "collect.cuh"
#include "predicates.cuh"
#include "time_planes.cuh"

namespace {

using aqpc::in_time_range;
using aqpc::kThreads;

__global__ void __launch_bounds__(kThreads)
time_count_multi_kernel(const int32_t* __restrict__ ths, const int32_t* __restrict__ tls,
                        const int32_t* __restrict__ qs, const int32_t* __restrict__ nvs,
                        int32_t* __restrict__ out, int64_t block_size, int64_t chunks,
                        int vec4) {
  const int64_t k = blockIdx.x / chunks;
  int q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = qs[k * 4 + j];
  const int64_t nv = aqpc::clamp_valid(nvs[k], block_size);
  const int32_t* h = ths + k * block_size;
  const int32_t* l = tls + k * block_size;
  const int64_t tid = (blockIdx.x - k * chunks) * blockDim.x + threadIdx.x;
  const int64_t stride = chunks * blockDim.x;

  int count = 0;
  if (vec4) {
    const int4* h4 = reinterpret_cast<const int4*>(h);
    const int4* l4 = reinterpret_cast<const int4*>(l);
    const int64_t n4 = nv / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 a = h4[i];
      const int4 b = l4[i];
      count += in_time_range(a.x, b.x, q) + in_time_range(a.y, b.y, q) +
               in_time_range(a.z, b.z, q) + in_time_range(a.w, b.w, q);
    }
    const int64_t i = n4 * 4 + tid;  // the last nv % 4 points, one thread each
    if (i < nv) count += in_time_range(h[i], l[i], q);
  } else {
    for (int64_t i = tid; i < nv; i += stride) count += in_time_range(h[i], l[i], q);
  }
  aqpc::cta_add(count, out + k);
}

// One word of 32 points a thread, the CTA walking (block, chunk) tiles.
template <class Tiles>
__global__ void __launch_bounds__(kThreads, Tiles::kMinCtas)
time_count_packed_kernel(Tiles f, int32_t* __restrict__ out, int64_t n_chunks, int64_t n_tiles) {
  aqpc::count_tiles(f, out, nullptr, n_chunks, n_tiles);
}

}  // namespace

// ths, tls: (K, B) int32 encoded hi/lo words; qs: (K, 4) int32 encoded
// ranges; nvs: (K,) int32; out: (K,) int32, zeroed by the caller. Returns
// cudaGetLastError().
extern "C" int aqpc_time_count_multi(const void* ths, const void* tls, const void* qs,
                                     const void* nvs, void* out, int64_t k_blocks,
                                     int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t chunks = aqpc::chunks_for(block_size, 16);
  if (k_blocks > aqpc::kMaxGridX / chunks) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ths) | reinterpret_cast<uintptr_t>(tls);
  const int vec4 = (block_size % 4 == 0) && (addr % 16 == 0);
  time_count_multi_kernel<<<static_cast<unsigned>(k_blocks * chunks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ths), static_cast<const int32_t*>(tls),
      static_cast<const int32_t*>(qs), static_cast<const int32_t*>(nvs),
      static_cast<int32_t*>(out), block_size, chunks, vec4);
  return static_cast<int>(cudaGetLastError());
}

// thp, tlp: (K, row width) u8 plane stacks of the hi and lo words at k_hi,
// k_lo bits in [0, 32]; qs: (K, 4) int32 residual-space ranges; otherwise
// as aqpc_time_count_multi.
extern "C" int aqpc_time_count_packed(const void* thp, const void* tlp, const void* qs,
                                      const void* nvs, void* out, int64_t k_blocks,
                                      int64_t block_size, int64_t k_hi, int64_t k_lo,
                                      void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  if (!aqpc::width_ok(k_hi, 32, block_size) || !aqpc::width_ok(k_lo, 32, block_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = aqpc::mask_chunks(block_size);
  const int64_t n_tiles = k_blocks * n_chunks;
  return aqpc::with_time_shape(
      aqpc::make_planes(thp, k_hi, block_size), aqpc::make_planes(tlp, k_lo, block_size), qs,
      nvs, block_size, [&](auto tiles) {
        static aqpc::ResidentCtas resident_of;
        const int64_t resident = resident_of(time_count_packed_kernel<decltype(tiles)>);
        time_count_packed_kernel<<<aqpc::tile_grid(n_tiles, resident), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
            tiles, static_cast<int32_t*>(out), n_chunks, n_tiles);
        return static_cast<int>(cudaGetLastError());
      });
}

// Multi-block closed-box count over bit-planar packed coordinates.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/predicate.py
//   unpack_bits_jnp + bbox_count_packed_jnp_multi (lines 480-505), which
//   XLA fuses, reached through parallel/mesh.py sharded_bbox_count_packed
//   (lines 95-121): the engine's default transport.
//
// Each axis is a (K, row width) u8 plane stack in the layout of
// unpack_planes.cuh. The residual is compared as int32 against
// residual-space bounds bounds[k] = [lo0, lo1, lo2, hi0, hi1, hi2]; rows
// i >= nv[k] are masked (padding rows carry lo = 0, hi = -1, nv = 0).
//
// What bounds it: device-memory reads, (kx + ky + kz) / 8 bytes per valid
// point, each byte once, as long as the compare stays cheap: rebuilding an
// int32 residual costs three integer operations per point and plane, which
// for a bit plane (an eighth of a byte) puts the limit on the integer pipes.
//
// What the design does about it (bbox_planes.cuh): the compare runs on the
// planes as they lie, 32 points a word, as two borrow chains from the lowest
// plane up, with every load of an axis started before its first compare. The
// widths are runtime arguments, so one compiled kernel serves every width
// combination. The grid is persistent, SM count x resident CTAs: a CTA
// walks tiles of kChunkWords words (one word per thread) across all K rows,
// keeps its count in registers while the row stays the same, and adds it to
// out[k] with one atomicAdd per row it touched. out is zeroed by the
// caller: that launch, and the one that joins los and his, are the floor
// the (0, 0, 0) width shows.
#include "bbox_planes.cuh"
#include "block_count.cuh"
#include "collect.cuh"

namespace {

using aqpc::kThreads;
using aqpc::Planes;

template <bool Wide>
__global__ void __launch_bounds__(kThreads, 2)
bbox_count_packed_kernel(aqpc::BoxTiles<Wide> f, int32_t* __restrict__ out, int64_t n_chunks,
                         int64_t n_tiles) {
  aqpc::count_tiles(f, out, nullptr, n_chunks, n_tiles);
}

template <bool Wide>
int launch(const Planes& ax, const Planes& ay, const Planes& az, const void* bounds,
           const void* nvs, void* out, int64_t k_blocks, int64_t block_size, void* stream) {
  static aqpc::ResidentCtas resident_of;
  const int64_t resident = resident_of(bbox_count_packed_kernel<Wide>);
  const int64_t n_chunks = aqpc::mask_chunks(block_size);
  const int64_t n_tiles = k_blocks * n_chunks;
  const aqpc::BoxTiles<Wide> f{ax, ay, az, static_cast<const int32_t*>(bounds),
                               static_cast<const int32_t*>(nvs), block_size};
  bbox_count_packed_kernel<Wide><<<aqpc::tile_grid(n_tiles, resident), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<int32_t*>(out), n_chunks, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xp, yp, zp: (K, row width of k bits) u8 plane stacks; bounds: (K, 6)
// int32 residual-space bounds; nvs: (K,) int32; out: (K,) int32, zeroed by
// the caller; kx, ky, kz in [0, 32]. Returns cudaGetLastError().
extern "C" int aqpc_bbox_count_packed(const void* xp, const void* yp, const void* zp,
                                      const void* bounds, const void* nvs, void* out,
                                      int64_t k_blocks, int64_t block_size, int64_t kx,
                                      int64_t ky, int64_t kz, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  if (!aqpc::width_ok(kx, 32, block_size) || !aqpc::width_ok(ky, 32, block_size) ||
      !aqpc::width_ok(kz, 32, block_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes ax = aqpc::make_planes(xp, kx, block_size);
  const Planes ay = aqpc::make_planes(yp, ky, block_size);
  const Planes az = aqpc::make_planes(zp, kz, block_size);
  return aqpc::planes_wide(block_size, xp, yp, zp)
             ? launch<true>(ax, ay, az, bounds, nvs, out, k_blocks, block_size, stream)
             : launch<false>(ax, ay, az, bounds, nvs, out, k_blocks, block_size, stream);
}

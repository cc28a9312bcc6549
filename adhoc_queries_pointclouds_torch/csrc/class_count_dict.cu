// Multi-block class count over dictionary-coded, bit-planar packed codes:
// the engine's default class transport.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/predicate.py
//   unpack_bits_jnp + class_count_dict_jnp_multi (lines 480-496, 597-601),
//   which XLA fuses, reached through parallel/mesh.py
//   sharded_class_count_dict (lines 193-216).
//
// Each block's class column is remapped on the host to codes into its
// sorted dictionary of present classes and shipped as k-bit planes, k in
// {1, 2, 4, 8} (8 when B % 8 != 0: byte planes only), in the layout of
// unpack_planes.cuh. targets[k] is the target's code in block k's
// dictionary, or len(dict) when the class is absent: no point carries that
// code, so the count is 0. out[k] = #{ i < nv[k] : code[k, i] == targets[k] }.
//
// What bounds it: device-memory reads, k / 8 bytes per valid point.
//
// What the design does about it: the test is the dictionary mask's
// (bbox_planes.cuh DictTiles: one axis of the packed box test at lo = hi =
// the target code, two borrow chains on the code planes as they lie, 32
// points a word, no code rebuilt; a body for each load kind and byte-plane
// count), on the persistent tile loop (collect.cuh count_tiles: SM count x
// resident CTAs walk the (chunk, block) tiles, any K), with the count in
// registers while the CTA's row is the same. A code outside the column (a
// miss) leaves the row's nv 0, so its planes are not read. A body is built
// for each width (its bit planes known, so a word's planes take 8 NB + MB
// registers), and a tile is kCountChunks chunks of a row, whose words'
// planes a thread loads before it counts: each thread keeps that many
// words' loads in flight. The output is written
// through a per-row ticket word in a workspace (collect.cuh row_done), so
// the caller launches no fill of out.
#include "bbox_planes.cuh"
#include "block_count.cuh"
#include "collect.cuh"

namespace {

using aqpc::DictTiles;
using aqpc::kThreads;

// Chunks a tile, a thread's words in flight: as many as keep their planes
// (8 NB + MB registers a word) within kCountRegs registers, at most 8
constexpr int kCountRegs = 16;
template <int NB, int MB>
constexpr int kCountChunks = 8 * NB + MB <= kCountRegs / 8 ? 8 : kCountRegs / (8 * NB + MB);

template <bool Wide, int NB, int MB>
__global__ void __launch_bounds__(kThreads, DictTiles<Wide, NB, MB>::kMinCtas)
class_count_dict_kernel(DictTiles<Wide, NB, MB> f, int32_t* __restrict__ out,
                        unsigned long long* __restrict__ work, int64_t row_tiles,
                        int64_t n_tiles) {
  aqpc::count_tiles<kCountChunks<NB, MB>>(f, out, work, row_tiles, n_tiles);
}

template <bool Wide, int NB, int MB>
int launch(const DictTiles<Wide, NB, MB>& f, void* out, void* work, int64_t k_blocks,
           void* stream) {
  static aqpc::ResidentCtas resident_of;
  const int64_t resident = resident_of(class_count_dict_kernel<Wide, NB, MB>);
  const int64_t row_tiles = aqpc::count_row_tiles(f.block_size, kCountChunks<NB, MB>);
  const int64_t n_tiles = k_blocks * row_tiles;
  class_count_dict_kernel<Wide, NB, MB><<<aqpc::tile_grid(n_tiles, resident), kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<int32_t*>(out), static_cast<unsigned long long*>(work), row_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cp: (K, row width of k bits) u8 code planes, k in [0, 8]; targets: (K,)
// int32 target codes (len(dict) on a miss); nvs: (K,) int32; out: (K,)
// int32, written (no fill needed); work: (K,) 64-bit workspace, all 0,
// left all 0. Any K. Returns cudaGetLastError().
extern "C" int aqpc_class_count_dict(const void* cp, const void* targets, const void* nvs,
                                     void* out, void* work, int64_t k_blocks,
                                     int64_t block_size, int64_t k_bits, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  if (!aqpc::width_ok(k_bits, 8, block_size)) return static_cast<int>(cudaErrorInvalidValue);
  const aqpc::Planes p = aqpc::make_planes(cp, k_bits, block_size);
  const auto* t = static_cast<const int32_t*>(targets);
  const auto* nv = static_cast<const int32_t*>(nvs);
  // a body for each load kind and width: k = 8 is one byte plane, k < 8 is
  // k bit planes
  return aqpc::with_int<1>(aqpc::planes_wide(block_size, cp), [&](auto wide) {
    constexpr bool kWide = decltype(wide)::value != 0;
    if (p.nbytes == 1) return launch(DictTiles<kWide, 1, 0>{p, t, nv, block_size}, out, work,
                                     k_blocks, stream);
    return aqpc::with_int<7>(p.nbits, [&](auto mb) {
      return launch(DictTiles<kWide, 0, decltype(mb)::value>{p, t, nv, block_size}, out, work,
                    k_blocks, stream);
    });
  });
}

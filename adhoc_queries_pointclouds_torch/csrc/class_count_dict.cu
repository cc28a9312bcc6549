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
// code, so the count is 0. out[k] = #{ i < nv[k] : code[k, i] == targets[k] }:
// one axis of the packed range test with lo = hi = the target code.
//
// What bounds it: device-memory reads, k / 8 bytes per valid point.
//
// What the design does about it: the packed bbox kernel's unpack
// (aqpc::unpack8), 8 points per thread in registers, the 8-point match mask
// (aqpc::dict_mask8) counted with popc, one atomicAdd per CTA. The collect
// mask of the same test rebuilds no code: it runs the one-column range
// chains on the planes as they lie (bbox_planes.cuh DictTiles), on the
// persistent tile loop, which this count can take with collect.cuh
// count_tiles.
#include "block_count.cuh"
#include "predicates.cuh"

namespace {

using aqpc::kThreads;
using aqpc::Planes;

__global__ void __launch_bounds__(kThreads)
class_count_dict_kernel(Planes cp, const int32_t* __restrict__ targets,
                        const int32_t* __restrict__ nvs, int32_t* __restrict__ out,
                        int64_t block_size) {
  const int64_t k = blockIdx.y;
  const int t = targets[k];
  const int64_t nv = aqpc::clamp_valid(nvs[k], block_size);
  const aqpc::PlaneRow row = aqpc::plane_row(cp, k, block_size);
  const int64_t groups = (nv + 7) / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  int count = 0;
  for (int64_t g = tid; g < groups; g += stride) {
    const int64_t left = nv - 8 * g;
    const int valid = left >= 8 ? 8 : static_cast<int>(left);
    count += __popc(aqpc::dict_mask8(row, t, block_size, g, valid));
  }
  aqpc::cta_add(count, out + k);
}

}  // namespace

// cp: (K, row width of k bits) u8 code planes, k in [0, 8]; targets: (K,)
// int32 target codes; nvs: (K,) int32; out: (K,) int32, zeroed by the
// caller. Returns cudaGetLastError().
extern "C" int aqpc_class_count_dict(const void* cp, const void* targets, const void* nvs,
                                     void* out, int64_t k_blocks, int64_t block_size,
                                     int64_t k_bits, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  if (k_blocks > aqpc::kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (!aqpc::width_ok(k_bits, 8, block_size)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(aqpc::chunks_for((block_size + 7) / 8, 4)),
                  static_cast<unsigned>(k_blocks));
  class_count_dict_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aqpc::make_planes(cp, k_bits, block_size), static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(nvs), static_cast<int32_t*>(out), block_size);
  return static_cast<int>(cudaGetLastError());
}

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
// point, each byte once; the unpack is a few shifts and ors per plane.
//
// What the design does about it: the widths are runtime arguments, so one
// compiled kernel serves every width combination. Each thread rebuilds 8
// consecutive points of each axis in registers (aqpc::unpack8), the 8-point
// hit mask is counted with popc, and the CTA's sum reaches out[k] with one
// atomicAdd.
#include "block_count.cuh"
#include "predicates.cuh"

namespace {

using aqpc::kThreads;
using aqpc::Planes;

__global__ void __launch_bounds__(kThreads)
bbox_count_packed_kernel(Planes ax, Planes ay, Planes az, const int32_t* __restrict__ bounds,
                         const int32_t* __restrict__ nvs, int32_t* __restrict__ out,
                         int64_t block_size) {
  const int64_t k = blockIdx.y;
  int b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = bounds[k * 6 + j];
  const int64_t nv = aqpc::clamp_valid(nvs[k], block_size);
  const aqpc::PlaneRow rx = aqpc::plane_row(ax, k, block_size);
  const aqpc::PlaneRow ry = aqpc::plane_row(ay, k, block_size);
  const aqpc::PlaneRow rz = aqpc::plane_row(az, k, block_size);
  const int64_t groups = (nv + 7) / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  int count = 0;
  for (int64_t g = tid; g < groups; g += stride) {
    const int64_t left = nv - 8 * g;
    const int valid = left >= 8 ? 8 : static_cast<int>(left);
    count += __popc(aqpc::bbox_packed_mask8(rx, ry, rz, b, block_size, g, valid));
  }
  aqpc::cta_add(count, out + k);
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
  if (k_blocks > aqpc::kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (!aqpc::width_ok(kx, 32, block_size) || !aqpc::width_ok(ky, 32, block_size) ||
      !aqpc::width_ok(kz, 32, block_size))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(aqpc::chunks_for((block_size + 7) / 8, 4)),
                  static_cast<unsigned>(k_blocks));
  bbox_count_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      aqpc::make_planes(xp, kx, block_size), aqpc::make_planes(yp, ky, block_size),
      aqpc::make_planes(zp, kz, block_size), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(nvs), static_cast<int32_t*>(out), block_size);
  return static_cast<int>(cudaGetLastError());
}

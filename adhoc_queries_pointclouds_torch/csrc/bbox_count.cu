// Multi-block closed-box count over raw int32 coordinates.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/predicate.py
//   _bbox_multi_kernel / bbox_count_pallas_multi (lines 281-333), and
//   _bbox_kernel / bbox_count_pallas (lines 81-135) as its K=1 launch.
//
// out[k] = #{ i < nv[k] : lo <= (x, y, z)[k, i] <= hi }, bounds[k] =
// [lo0, lo1, lo2, hi0, hi1, hi2], all int32 compares on raw local
// coordinates.
//
// What bounds it: device-memory reads, 12 bytes per valid point (x, y, z
// once each); the compare is 6 integer ops per point. Rows past nv[k] are
// padding and are never read.
//
// What the design does about it: one CTA row of `chunks` CTAs a block, the
// rows flattened into the grid's x (any K); every CTA strides over one
// block's valid prefix with 16-byte int4 loads (neighbouring
// threads on neighbouring addresses) when the rows are 16-byte aligned, and
// scalar loads otherwise, so any block size works. Counts stay in registers;
// one atomicAdd per CTA reaches memory.
#include "block_count.cuh"
#include "predicates.cuh"

namespace {

using aqpc::in_box;
using aqpc::kThreads;

__global__ void __launch_bounds__(kThreads)
bbox_count_multi_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                        const int32_t* __restrict__ zs, const int32_t* __restrict__ bounds,
                        const int32_t* __restrict__ nvs, int32_t* __restrict__ out,
                        int64_t block_size, int64_t chunks, int vec4) {
  const int64_t k = blockIdx.x / chunks;
  int b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = bounds[k * 6 + j];
  const int64_t nv = aqpc::clamp_valid(nvs[k], block_size);
  const int32_t* x = xs + k * block_size;
  const int32_t* y = ys + k * block_size;
  const int32_t* z = zs + k * block_size;
  const int64_t tid = (blockIdx.x - k * chunks) * blockDim.x + threadIdx.x;
  const int64_t stride = chunks * blockDim.x;

  int count = 0;
  if (vec4) {
    const int4* x4 = reinterpret_cast<const int4*>(x);
    const int4* y4 = reinterpret_cast<const int4*>(y);
    const int4* z4 = reinterpret_cast<const int4*>(z);
    const int64_t n4 = nv / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 a = x4[i];
      const int4 c = y4[i];
      const int4 d = z4[i];
      count += in_box(a.x, c.x, d.x, b) + in_box(a.y, c.y, d.y, b) +
               in_box(a.z, c.z, d.z, b) + in_box(a.w, c.w, d.w, b);
    }
    const int64_t i = n4 * 4 + tid;  // the last nv % 4 points, one thread each
    if (i < nv) count += in_box(x[i], y[i], z[i], b);
  } else {
    for (int64_t i = tid; i < nv; i += stride) count += in_box(x[i], y[i], z[i], b);
  }
  aqpc::cta_add(count, out + k);
}

}  // namespace

// xs, ys, zs: (K, B) int32; bounds: (K, 6) int32; nvs: (K,) int32;
// out: (K,) int32, zeroed by the caller. Returns cudaGetLastError().
extern "C" int aqpc_bbox_count_multi(const void* xs, const void* ys, const void* zs,
                                     const void* bounds, const void* nvs, void* out,
                                     int64_t k_blocks, int64_t block_size, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t chunks = aqpc::chunks_for(block_size, 16);
  if (k_blocks > aqpc::kMaxGridX / chunks) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(ys) |
                         reinterpret_cast<uintptr_t>(zs);
  const int vec4 = (block_size % 4 == 0) && (addr % 16 == 0);
  bbox_count_multi_kernel<<<static_cast<unsigned>(k_blocks * chunks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(zs), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(nvs), static_cast<int32_t*>(out), block_size, chunks, vec4);
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by an entry point.
extern "C" const char* aqpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

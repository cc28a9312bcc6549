// The bbox probe variants: one closed-box count over (n,) int32 columns,
// accumulated per thread across the whole scan and reduced once.
//
// Replaces: tools/bboxprobe.py (the JAX package's probe tool)
//   bbox_probe (line 130) -> _call_bbox (line 114) with the bodies
//   _bbox_kernel_acc (line 60): mask i < n_valid, accumulate the hit mask
//     elementwise in a VMEM tile over the sequential grid, sum the tile
//     once at the last grid step;
//   _bbox_kernel_acc_nomask (line 87): the same without the n_valid mask.
// They probed whether the library kernel's per-grid-step reduction
// (csrc/bbox_count.cu's TPU counterpart) cost anything against one final
// reduction.
//
// out = #{ i < bound : lo <= (x, y, z)[i] <= hi }, bounds = [lo0, lo1, lo2,
// hi0, hi1, hi2]; bound = clamp(n_valid, 0, n), read on the device, for acc
// and n for acc_nomask (the probe passes n_valid = n, so both count the same
// points).
//
// What bounds it: device-memory reads, 12 bytes per point.
//
// What the design does about it: the counterpart of "accumulate in a tile,
// reduce once" on a card whose CTAs run in parallel and in no order is a
// persistent grid, about SM count x resident CTAs per SM, in which every
// thread keeps its count in a register over a grid-stride range of 16-byte
// int4 loads (scalar loads when a row is not 16-byte aligned or n % 4 != 0
// leaves a tail), then one reduction across the whole grid at the end: each
// CTA stores its sum in a partials slot, and the last CTA to finish (an
// atomic ticket after a __threadfence) adds the partials in slot order and
// writes out. The n_valid mask of acc is the loop bound, a scalar: on this
// card it costs no per-element work, unlike the TPU's iota chain.
#include "block_count.cuh"
#include "predicates.cuh"

namespace {

using aqpc::in_box;
using aqpc::kThreads;

__global__ void __launch_bounds__(kThreads)
bbox_probe_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, const int32_t* __restrict__ bounds,
                  const int32_t* __restrict__ nv, int64_t n, int vec4,
                  int32_t* __restrict__ partials, unsigned* __restrict__ ticket,
                  int32_t* __restrict__ out) {
  int b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = bounds[j];
  const int64_t bound = nv ? aqpc::clamp_valid(*nv, n) : n;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  int count = 0;
  if (vec4) {
    const int4* x4 = reinterpret_cast<const int4*>(x);
    const int4* y4 = reinterpret_cast<const int4*>(y);
    const int4* z4 = reinterpret_cast<const int4*>(z);
    const int64_t n4 = bound / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 a = x4[i];
      const int4 c = y4[i];
      const int4 d = z4[i];
      count += in_box(a.x, c.x, d.x, b) + in_box(a.y, c.y, d.y, b) + in_box(a.z, c.z, d.z, b) +
               in_box(a.w, c.w, d.w, b);
    }
    for (int64_t i = n4 * 4 + tid; i < bound; i += stride) count += in_box(x[i], y[i], z[i], b);
  } else {
    for (int64_t i = tid; i < bound; i += stride) count += in_box(x[i], y[i], z[i], b);
  }

  __shared__ bool last;
  count = aqpc::cta_sum(count);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = count;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int sum = 0;
  for (int64_t j = threadIdx.x; j < gridDim.x; j += kThreads)
    sum += *static_cast<volatile int32_t*>(partials + j);
  sum = aqpc::cta_sum(sum);
  if (threadIdx.x == 0) {
    *out = sum;
    *ticket = 0;  // ready for the next launch
  }
}

int launch(const void* x, const void* y, const void* z, const void* bounds, const void* nv,
           int64_t n, void* partials, int64_t capacity, void* ticket, void* out,
           void* stream) {
  if (n < 0 || capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bbox_probe_kernel, kThreads, 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(z);
  const int vec4 = addr % 16 == 0;
  // no more CTAs than there is work for, none fewer than 1
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t work = aqpc::chunks_for((n + 3) / 4, 1);
  grid = grid < work ? grid : work;
  grid = grid < capacity ? grid : capacity;
  bbox_probe_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(nv), n, vec4,
      static_cast<int32_t*>(partials), static_cast<unsigned*>(ticket),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, z: (n,) int32; bounds: (6,) int32 [lo, hi]; nv: (1,) int32
// n_valid; partials: (capacity,) int32 scratch; ticket: (1,) int32, zero
// before the first launch (each launch leaves it zero); out: (1,) int32.
// Returns cudaGetLastError().
extern "C" int aqpc_bbox_probe_acc(const void* x, const void* y, const void* z,
                                   const void* bounds, const void* nv, void* partials,
                                   void* ticket, void* out, int64_t n, int64_t capacity,
                                   void* stream) {
  return launch(x, y, z, bounds, nv, n, partials, capacity, ticket, out, stream);
}

// As aqpc_bbox_probe_acc with the bound at n: no n_valid.
extern "C" int aqpc_bbox_probe_acc_nomask(const void* x, const void* y, const void* z,
                                          const void* bounds, void* partials, void* ticket,
                                          void* out, int64_t n, int64_t capacity,
                                          void* stream) {
  return launch(x, y, z, bounds, nullptr, n, partials, capacity, ticket, out, stream);
}

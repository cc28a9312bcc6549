// Shared pieces of the count kernels: launch shape and the per-CTA count
// reduction. Every count kernel ends the same way: each thread holds an int
// count, the CTA sums it (warp shuffles, then one warp over the warp sums)
// and one thread adds the CTA's sum into out[k] with an integer atomic.
// Integer atomics are exact, so the result does not depend on the order in
// which CTAs finish.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace aqpc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CUDA caps gridDim.x at 2^31 - 1: the grids of one CTA a (chunk, block)
// tile are flattened into x.
constexpr int64_t kMaxGridX = 2147483647;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The CTA-wide sum of `count`, valid in thread 0 only. Every thread of the
// CTA must call it (it holds a __syncthreads).
__device__ __forceinline__ int cta_sum(int count) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  count = warp_sum(count);
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) count = warp_sum(lane < kWarps ? warp_sums[lane] : 0);
  return count;
}

// Adds the CTA-wide sum of `count` into *out. Every thread of the CTA must
// call it (it holds a __syncthreads).
__device__ __forceinline__ void cta_add(int count, int32_t* out) {
  count = cta_sum(count);
  if (threadIdx.x == 0 && count != 0) atomicAdd(out, count);
}

// Rows past n_valid are padding; a negative or oversized n_valid is clamped.
__device__ __forceinline__ int64_t clamp_valid(int64_t nv, int64_t block_size) {
  return nv < 0 ? 0 : (nv > block_size ? block_size : nv);
}

// SM count x resident CTAs of `kernel` at kThreads threads: the size of a
// persistent grid.
template <class Kernel>
inline int64_t resident_ctas(Kernel kernel) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t n = static_cast<int64_t>(sms) * per_sm;
  return n < 1 ? 1 : n;
}

// resident_ctas(kernel) of the current device, worked out once a device: the
// cards of one host may differ in SM count, so a launch on another card must
// not take the first card's grid. One instance a launch site, held in a
// function-local static (zeroed before first use), so each kernel keeps its own.
class ResidentCtas {
 public:
  template <class Kernel>
  int64_t operator()(Kernel kernel) {
    int device = 0;
    cudaGetDevice(&device);
    if (device < 0 || device >= kMaxDevices) return resident_ctas(kernel);
    int64_t n = n_[device].load(std::memory_order_relaxed);
    if (n == 0) {
      n = resident_ctas(kernel);
      n_[device].store(n, std::memory_order_relaxed);
    }
    return n;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::atomic<int64_t> n_[kMaxDevices];
};

// Number of CTAs along one block's row so that each thread handles about
// `items_per_thread` work items of `n_items`.
inline int64_t chunks_for(int64_t n_items, int64_t items_per_thread) {
  const int64_t per_cta = kThreads * items_per_thread;
  const int64_t c = (n_items + per_cta - 1) / per_cta;
  return c < 1 ? 1 : c;
}

// f(std::integral_constant<int, n>{}) for n in [0, N]; cudaErrorInvalidValue
// for any other n.
template <int N, class F>
inline int with_int(int n, F&& f) {
  if constexpr (N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n == N) return f(std::integral_constant<int, N>{});
    return with_int<N - 1>(n, f);
  }
}

}  // namespace aqpc

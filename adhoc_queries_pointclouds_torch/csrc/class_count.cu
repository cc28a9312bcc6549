// Multi-block class-equality count over the raw u8 classification column.
//
// Replaces: adhoc_queries_pointclouds_tpu/ops/predicate.py
//   _class_multi_kernel / class_count_pallas_multi (lines 336-380), (c);
//   _class_kernel / class_count_pallas (lines 138-181), (d), as its K=1
//   launch;
//   _class_packed_multi_kernel / class_count_packed_pallas_multi (lines
//   733-779), (e): the same column viewed as int32 words, 4 points each;
//   _class_packed_kernel / class_count_packed_pallas (lines 683-730), (f),
//   as its K=1 launch.
//
// out[k] = #{ i < nv[k] : cls[k, i] == targets[k] }. On the TPU the u8 and
// word forms were two kernels because the VPU's element rate, not bytes,
// bounded the u8 scan (predicate.py:609-622). Here both count the same
// bytes, so one device body serves both entry points; they differ only in
// how a target outside 0..255 behaves. The u8 entry compares the byte as an
// int (no match), and the word entry replicates the target into a word as
// uint32(t) * 0x01010101, exactly as (e) does.
//
// What bounds it: device-memory reads, 1 byte per valid point.
//
// What the design does about it: each thread loads 16 bytes at a time as
// four 32-bit words and tests each with __vcmpeq4 (0xff at each equal
// byte) and __popc >> 3, the SWAR equality test of (e) in one instruction.
// The last partial chunk is masked per byte in little-endian order, as
// _packed_keep does. A row that does not start on a 16-byte boundary, or
// whose length is not a multiple of 16, takes byte loads. The CTA's count
// reaches out[k] with one integer atomic.
#include "block_count.cuh"

namespace {

using aqpc::kThreads;

// The low n bytes of a word, n clamped to [0, 4].
__device__ __forceinline__ uint32_t keep_bytes(int64_t n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

__device__ __forceinline__ int equal_bytes(uint32_t w, uint32_t rep, uint32_t keep) {
  return __popc(__vcmpeq4(w, rep) & keep) >> 3;
}

// Bytes of row[0, nv) equal to byte i % 4 of rep (row byte i against the
// byte it meets when the row is read as little-endian words), over this
// thread's share of the row.
__device__ __forceinline__ int count_equal_bytes(const uint8_t* __restrict__ row, int64_t nv,
                                                 uint32_t rep, bool vec16, int64_t tid,
                                                 int64_t stride) {
  int count = 0;
  if (vec16) {
    const uint4* row16 = reinterpret_cast<const uint4*>(row);
    const int64_t chunks = (nv + 15) / 16;
    for (int64_t c = tid; c < chunks; c += stride) {
      const uint4 v = row16[c];
      const int64_t left = nv - 16 * c;
      if (left >= 16) {
        count += (__popc(__vcmpeq4(v.x, rep)) + __popc(__vcmpeq4(v.y, rep)) +
                  __popc(__vcmpeq4(v.z, rep)) + __popc(__vcmpeq4(v.w, rep))) >> 3;
      } else {
        count += equal_bytes(v.x, rep, keep_bytes(left)) +
                 equal_bytes(v.y, rep, keep_bytes(left - 4)) +
                 equal_bytes(v.z, rep, keep_bytes(left - 8)) +
                 equal_bytes(v.w, rep, keep_bytes(left - 12));
      }
    }
  } else {
    for (int64_t i = tid; i < nv; i += stride)
      count += row[i] == ((rep >> (8 * (i & 3))) & 0xffu);
  }
  return count;
}

// cols: (K, B) bytes; words != 0 selects the word entry's target rule.
__global__ void __launch_bounds__(kThreads)
class_count_kernel(const uint8_t* __restrict__ cols, const int32_t* __restrict__ targets,
                   const int32_t* __restrict__ nvs, int32_t* __restrict__ out,
                   int64_t block_size, int words) {
  const int64_t k = blockIdx.y;
  int64_t nv = nvs[k];
  nv = nv < 0 ? 0 : (nv > block_size ? block_size : nv);
  const uint8_t* row = cols + k * block_size;
  const int t = targets[k];
  const bool any = words || (t >= 0 && t <= 255);
  const uint32_t rep = static_cast<uint32_t>(t) * 0x01010101u;
  const bool vec16 = block_size % 16 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int count = any ? count_equal_bytes(row, nv, rep, vec16, tid, stride) : 0;
  aqpc::cta_add(count, out + k);
}

int launch(const void* cols, const void* targets, const void* nvs, void* out,
           int64_t k_blocks, int64_t block_size, int words, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  if (k_blocks > aqpc::kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(aqpc::chunks_for((block_size + 15) / 16, 4)),
                  static_cast<unsigned>(k_blocks));
  class_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int32_t*>(targets),
      static_cast<const int32_t*>(nvs), static_cast<int32_t*>(out), block_size, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cls: (K, B) u8; targets, nvs: (K,) int32; out: (K,) int32, zeroed by the
// caller. Any B. Returns cudaGetLastError().
extern "C" int aqpc_class_count_multi(const void* cls, const void* targets, const void* nvs,
                                      void* out, int64_t k_blocks, int64_t block_size,
                                      void* stream) {
  return launch(cls, targets, nvs, out, k_blocks, block_size, 0, stream);
}

// words: (K, W) int32, the (K, 4W) u8 column viewed little-endian; nvs in
// points; otherwise as aqpc_class_count_multi.
extern "C" int aqpc_class_count_words(const void* words, const void* targets, const void* nvs,
                                      void* out, int64_t k_blocks, int64_t n_words,
                                      void* stream) {
  return launch(words, targets, nvs, out, k_blocks, 4 * n_words, 1, stream);
}

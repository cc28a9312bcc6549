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
// how a target outside 0..255 behaves (class_tiles.cuh): the u8 entry
// compares the byte as an int (no match, and the row is not read), and the
// word entry replicates the target into a word as uint32(t) * 0x01010101,
// exactly as (e) does.
//
// What bounds it: device-memory reads, 1 byte per valid point.
//
// What the design does about it: the test is the class mask's
// (class_tiles.cuh ClassRawTiles: a warp reads 1024 points as one 16-byte
// streaming load a lane for each 512, __vcmpeq4 tests four points an
// instruction; rows off 16-byte boundaries or B % 16 != 0 take realigned
// 4-byte loads) on the persistent tile loop (collect.cuh count_tiles: SM
// count x resident CTAs walk the (chunk, block) tiles, any K). A count
// needs no mask word, so each lane adds the equal bytes of its own loads
// (__popc of __vcmpeq4 under a byte mask at nv) with no shuffle, and the
// count stays in registers while the CTA's row is the same. The output is
// written, not added to: each CTA adds its row sum and a ticket to its
// row's word in a workspace with one 64-bit atomic, and the CTA that draws
// the row's last ticket stores the sum and zeroes the word again
// (collect.cuh row_done), so the caller launches no fill of out. A tile is
// kCountChunks chunks of a row, whose loads a thread issues before it
// counts, so that each thread keeps that many loads in flight.
#include "block_count.cuh"
#include "class_tiles.cuh"
#include "collect.cuh"

namespace {

using aqpc::ClassRawTiles;
using aqpc::kThreads;

// Chunks a tile (a thread's loads in flight), and the CTAs an SM the body
// is built for
constexpr int kCountChunks = 2;
constexpr int kCountCtas = 8;

template <bool Wide>
__global__ void __launch_bounds__(kThreads, kCountCtas)
class_count_kernel(ClassRawTiles<Wide> f, int32_t* __restrict__ out,
                   unsigned long long* __restrict__ work, int64_t row_tiles, int64_t n_tiles) {
  aqpc::count_tiles<kCountChunks>(f, out, work, row_tiles, n_tiles);
}

template <bool Wide>
int launch(const ClassRawTiles<Wide>& f, void* out, void* work, int64_t k_blocks,
           void* stream) {
  static aqpc::ResidentCtas resident_of;
  const int64_t resident = resident_of(class_count_kernel<Wide>);
  const int64_t row_tiles = aqpc::count_row_tiles(f.block_size, kCountChunks);
  const int64_t n_tiles = k_blocks * row_tiles;
  class_count_kernel<Wide><<<aqpc::tile_grid(n_tiles, resident), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<int32_t*>(out), static_cast<unsigned long long*>(work), row_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int count(const void* cls, const void* targets, const void* nvs, void* out, void* work,
          int64_t k_blocks, int64_t block_size, bool words, void* stream) {
  if (k_blocks <= 0 || block_size <= 0) return static_cast<int>(cudaGetLastError());
  const auto* c = static_cast<const uint8_t*>(cls);
  const auto* t = static_cast<const int32_t*>(targets);
  const auto* nv = static_cast<const int32_t*>(nvs);
  if (block_size % 16 != 0 || reinterpret_cast<uintptr_t>(cls) % 16 != 0)
    return launch(ClassRawTiles<false>{c, t, nv, block_size, words}, out, work, k_blocks, stream);
  return launch(ClassRawTiles<true>{c, t, nv, block_size, words}, out, work, k_blocks, stream);
}

}  // namespace

// cls: (K, B) u8; targets, nvs: (K,) int32; out: (K,) int32, written (no
// fill needed); work: (K,) 64-bit workspace, all 0, left all 0. Any B and
// K. Returns cudaGetLastError().
extern "C" int aqpc_class_count_multi(const void* cls, const void* targets, const void* nvs,
                                      void* out, void* work, int64_t k_blocks,
                                      int64_t block_size, void* stream) {
  return count(cls, targets, nvs, out, work, k_blocks, block_size, false, stream);
}

// words: (K, W) int32, the (K, 4W) u8 column viewed little-endian; nvs in
// points; otherwise as aqpc_class_count_multi.
extern "C" int aqpc_class_count_words(const void* words, const void* targets, const void* nvs,
                                      void* out, void* work, int64_t k_blocks, int64_t n_words,
                                      void* stream) {
  return count(words, targets, nvs, out, work, k_blocks, 4 * n_words, true, stream);
}

// Density candidate selection: per-cell leaders, then the margin test.
//
// Replaces adhoc_queries_pointclouds_tpu/ops/density.py
// _density_candidates_1 (lines 339-411), reached through
// density_candidates_multi (:430) and block_density_candidates (:418), which
// XLA fuses around a 5-key sort and an associative scan. The surviving set
// depends only on each cell's least d2, so there is no sort here:
//
//   pass 1, density_leaders[_packed]: every point of the step's predicate
//     mask below n_valid gets its cell (an f32 estimate refined against the
//     file's exact int32 boundary tables) and its f32 d2 to the cell centre;
//     a certified point atomicMins its d2 into the slot of its cell in the
//     block's open-addressing table.
//   pass 2, density_candidates[_packed]: recomputes cell and d2 (cheaper
//     than storing 16 bytes a point), reads the cell's leader and keeps the
//     point if d2 <= (leader + 1e-5 * leader) + eps_abs; uncertified points
//     are kept wholesale. The result is a bit mask with per-chunk and
//     per-block counts in the layout of collect.cuh, which compact_bits.cu
//     turns into ascending indices.
//
// The table: K regions of `slots` (a power of two) uint64 keys, then K
// regions of `slots` uint32 values, cleared to all ones by the pass 1 entry
// (one cudaMemsetAsync, part of the kernel's time). A key is the cell's
// linear index (cz * dimy + cy) * dimx + cx; the grid has at most 2^64
// cells, so it fits. All ones means "empty": the one cell that could have
// that key (the last cell of a grid of exactly 2^64 cells) is treated as
// uncertified, so its points survive. A value is the bit pattern of a d2
// >= +0, which orders as the float does; all ones is above every d2. A
// NaN d2 never enters the table: such a point is uncertified. The caller
// sizes the table at two slots or more per predicate hit; if a block's
// region fills all the same, pass 1 drops the cell and pass 2 keeps every
// point whose cell it does not find, so the candidates stay a superset.
//
// Arithmetic equals the plain PyTorch version bit for bit: __fsub_rn,
// __fmul_rn and __fadd_rn keep each product and sum rounded on its own (no
// fused multiply-add), the two wrapping subtractions run unsigned, and the
// estimate is clamped to [-1, dim] as a float (NaN to -1) before it is
// truncated.
//
// What bounds it: device-memory reads of x, y and z (12 bytes a point, or
// the planes' bytes) in both passes, plus one bit a point in and out; the
// tables are a few KiB and stay in L2. Dense masks over few cells add
// atomic contention on the leaders.
//
// What the design does about it: one CTA per (8192-row chunk, block); a
// thread takes a group of 8 consecutive points (two 16-byte loads per raw
// column, or aqpc::unpack8 of the planes, base added), skips groups with
// no predicate hit without loading them, and four lanes OR their 8-bit
// results into a mask word with two shuffles. A simple design: nothing
// here is tuned.
#include <climits>

#include "block_count.cuh"
#include "collect.cuh"
#include "unpack_planes.cuh"

namespace {

using aqpc::kChunkWords;
using aqpc::kThreads;
using aqpc::kWarps;
using aqpc::MaskOut;
using aqpc::PlaneRow;
using aqpc::Planes;

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmptyKey = ~0ull;
constexpr float kEpsRel = 1e-5f;

// The per-file tables of GridSpec3D.file_tables, as device pointers.
struct Tables {
  const int32_t* b[3];   // dim + 2 exact cell boundaries
  const int32_t* cr[3];  // dim cell centres, rounded
  const float* cf[3];    // dim cell centres, fraction
  const int32_t* q0i;    // (3,)
  const float* q0f;
  const float* dpl;
  const float* scale;
  const float* eps_abs;  // (1,)
  int dim[3];
};

struct Axis {
  const int32_t* b;
  const int32_t* cr;
  const float* cf;
  int q0i;
  float q0f;
  float dpl;
  float scale;
  int dim;
};

struct Grid {
  Axis a[3];
  float eps_abs;
};

__device__ __forceinline__ Grid load_grid(const Tables& t) {
  Grid g;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g.a[i] = Axis{t.b[i], t.cr[i], t.cf[i], t.q0i[i], t.q0f[i], t.dpl[i], t.scale[i], t.dim[i]};
  g.eps_abs = t.eps_abs[0];
  return g;
}

// One axis: the cell of p, the scaled distance to its centre, and whether
// the tables certify the cell.
__device__ __forceinline__ bool axis_cell(const Axis& a, int p, int* cell, float* dist) {
  const int off = static_cast<int>(static_cast<unsigned>(p) - static_cast<unsigned>(a.q0i));
  float est = __fmul_rn(__fsub_rn(__int2float_rn(off), a.q0f), a.dpl);
  est = fminf(fmaxf(est, -1.0f), static_cast<float>(a.dim));  // NaN -> -1
  int c = __float2int_rz(est);
  c = min(max(c, 0), a.dim - 1);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (p >= a.b[min(c + 1, a.dim)]) ++c;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (p < a.b[c]) --c;
  c = min(max(c, 0), a.dim - 1);
  bool ok = p >= a.b[c] && p < a.b[c + 1] && p < a.b[a.dim] && p < INT_MAX && p > INT_MIN;
  const int di = static_cast<int>(static_cast<unsigned>(p) - static_cast<unsigned>(a.cr[c]));
  ok = ok && di > -(1 << 30) && di < (1 << 30);
  *dist = __fmul_rn(__fsub_rn(__int2float_rn(di), a.cf[c]), a.scale);
  *cell = c;
  return ok;
}

struct Cell {
  unsigned long long key;
  float d2;
  bool certified;
};

__device__ __forceinline__ Cell cell_of(const Grid& g, int x, int y, int z) {
  int cx, cy, cz;
  float dx, dy, dz;
  const bool okx = axis_cell(g.a[0], x, &cx, &dx);
  const bool oky = axis_cell(g.a[1], y, &cy, &dy);
  const bool okz = axis_cell(g.a[2], z, &cz, &dz);
  Cell c;
  c.d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  c.key = (static_cast<unsigned long long>(cz) * static_cast<unsigned long long>(g.a[1].dim) +
           static_cast<unsigned long long>(cy)) *
              static_cast<unsigned long long>(g.a[0].dim) +
          static_cast<unsigned long long>(cx);
  c.certified = okx && oky && okz && !isnan(c.d2) && c.key != kEmptyKey;
  return c;
}

__device__ __forceinline__ unsigned long long mix(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

// One block's region of the leaders table.
struct Leaders {
  unsigned long long* keys;
  unsigned* vals;
  unsigned long long last;  // slots - 1
};

// atomicMin of d2's bits into the slot of key, claiming an empty slot by
// linear probing. A stale read can only show "empty" for a slot that has a
// key by now, and the compare-and-swap then returns that key.
__device__ __forceinline__ void leader_min(const Leaders& t, unsigned long long key, float d2) {
  unsigned long long h = mix(key) & t.last;
  for (unsigned long long n = 0; n <= t.last; ++n) {
    unsigned long long cur = __ldcg(t.keys + h);
    if (cur == kEmptyKey) {
      cur = atomicCAS(t.keys + h, kEmptyKey, key);
      if (cur == kEmptyKey) cur = key;
    }
    if (cur == key) {
      atomicMin(t.vals + h, __float_as_uint(d2));
      return;
    }
    h = (h + 1) & t.last;
  }
}

// The leader of key's cell; false if the table does not hold the cell.
__device__ __forceinline__ bool leader_of(const Leaders& t, unsigned long long key,
                                          float* leader) {
  unsigned long long h = mix(key) & t.last;
  for (unsigned long long n = 0; n <= t.last; ++n) {
    const unsigned long long cur = t.keys[h];
    if (cur == key) {
      *leader = __uint_as_float(t.vals[h]);
      return true;
    }
    if (cur == kEmptyKey) return false;
    h = (h + 1) & t.last;
  }
  return false;
}

// Raw (B,) int32 columns of one block.
struct RawSrc {
  const int32_t *x, *y, *z;
  bool aligned;  // rows on 16-byte boundaries

  __device__ __forceinline__ static void load(const int32_t* col, bool wide, int valid,
                                              int (&v)[8]) {
    if (wide) {
      const int4 lo = reinterpret_cast<const int4*>(col)[0];
      const int4 hi = reinterpret_cast<const int4*>(col)[1];
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = i < valid ? col[i] : 0;
    }
  }

  __device__ __forceinline__ void load8(int64_t g, int valid, int (&vx)[8], int (&vy)[8],
                                        int (&vz)[8]) const {
    const bool wide = aligned && valid == 8;
    load(x + 8 * g, wide, valid, vx);
    load(y + 8 * g, wide, valid, vy);
    load(z + 8 * g, wide, valid, vz);
  }
};

// Bit-planar residual planes of one block, rebuilt to absolute int32.
struct PackedSrc {
  PlaneRow px, py, pz;
  unsigned base[3];
  int64_t block_size;

  __device__ __forceinline__ void load(const PlaneRow& p, unsigned b, int64_t g, int valid,
                                       int (&v)[8]) const {
    uint32_t r[8];
    aqpc::unpack8(p.row, block_size, p.nbytes, p.nbits, g, valid, p.aligned, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = static_cast<int>(r[i] + b);
  }

  __device__ __forceinline__ void load8(int64_t g, int valid, int (&vx)[8], int (&vy)[8],
                                        int (&vz)[8]) const {
    load(px, base[0], g, valid, vx);
    load(py, base[1], g, valid, vy);
    load(pz, base[2], g, valid, vz);
  }
};

// The CTA's chunk of one block: lane l of a warp takes the 8 points of group
// 4 * wb + l, so the warp covers mask words wb..wb+7. Pass 1 (Second false)
// fills the leaders; pass 2 writes the candidates' words and counts.
template <bool Second, class Src>
__device__ __forceinline__ void density_chunk(const Src& src, const Grid& g,
                                              const uint32_t* __restrict__ mask, int64_t nv,
                                              const Leaders& t, const MaskOut& o) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kChunkWords;
  const int64_t w1 = w0 + kChunkWords < o.n_words ? w0 + kChunkWords : o.n_words;
  int count = 0;
  for (int64_t wb = w0 + 8 * warp; wb < w1; wb += 8 * kWarps) {
    const int64_t grp = 4 * wb + lane;
    const int64_t w = wb + (lane >> 2);
    const int64_t left = nv - 8 * grp;
    const int valid = left >= 8 ? 8 : (left <= 0 ? 0 : static_cast<int>(left));
    unsigned m = 0;
    if (valid) m = (mask[w] >> (8 * (lane & 3))) & aqpc::group_valid_mask(valid);
    unsigned keep = 0;
    if (m) {
      int vx[8], vy[8], vz[8];
      src.load8(grp, valid, vx, vy, vz);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!((m >> i) & 1u)) continue;
        const Cell c = cell_of(g, vx[i], vy[i], vz[i]);
        if (!Second) {
          if (c.certified) leader_min(t, c.key, c.d2);
        } else {
          // kept unless its cell has a leader that beats it by the margin
          bool k = true;
          float lead;
          if (c.certified && leader_of(t, c.key, &lead))
            k = c.d2 <= __fadd_rn(__fadd_rn(lead, __fmul_rn(kEpsRel, lead)), g.eps_abs);
          keep |= static_cast<unsigned>(k) << i;
        }
      }
    }
    if (Second) {
      unsigned word = keep << (8 * (lane & 3));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      if ((lane & 3) == 0 && w < w1) {
        o.bits[static_cast<int64_t>(blockIdx.y) * o.n_words + w] = word;
        count += __popc(word);
      }
    }
  }
  if (Second) aqpc::finish_chunk(count, o);
}

__device__ __forceinline__ Leaders leaders_of(void* table, int64_t k_blocks, int64_t slots) {
  auto* keys = static_cast<unsigned long long*>(table);
  auto* vals = reinterpret_cast<unsigned*>(keys + k_blocks * slots);
  const int64_t k = blockIdx.y;
  return Leaders{keys + k * slots, vals + k * slots, static_cast<unsigned long long>(slots - 1)};
}

template <bool Second>
__global__ void __launch_bounds__(kThreads)
density_raw_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                   const int32_t* __restrict__ zs, const uint32_t* __restrict__ mask,
                   const int32_t* __restrict__ nvs, Tables tables, void* table, int64_t slots,
                   MaskOut o, int64_t k_blocks, int64_t block_size) {
  const int64_t k = blockIdx.y;
  const RawSrc src{xs + k * block_size, ys + k * block_size, zs + k * block_size,
                   (reinterpret_cast<uintptr_t>(xs + k * block_size) |
                    reinterpret_cast<uintptr_t>(ys + k * block_size) |
                    reinterpret_cast<uintptr_t>(zs + k * block_size)) % 16 == 0};
  density_chunk<Second>(src, load_grid(tables), mask + k * o.n_words,
                        aqpc::clamp_valid(nvs[k], block_size), leaders_of(table, k_blocks, slots),
                        o);
}

template <bool Second>
__global__ void __launch_bounds__(kThreads)
density_packed_kernel(Planes ax, Planes ay, Planes az, const int32_t* __restrict__ bases,
                      const uint32_t* __restrict__ mask, const int32_t* __restrict__ nvs,
                      Tables tables, void* table, int64_t slots, MaskOut o, int64_t k_blocks,
                      int64_t block_size) {
  const int64_t k = blockIdx.y;
  const PackedSrc src{aqpc::plane_row(ax, k, block_size), aqpc::plane_row(ay, k, block_size),
                      aqpc::plane_row(az, k, block_size),
                      {static_cast<unsigned>(bases[3 * k]), static_cast<unsigned>(bases[3 * k + 1]),
                       static_cast<unsigned>(bases[3 * k + 2])},
                      block_size};
  density_chunk<Second>(src, load_grid(tables), mask + k * o.n_words,
                        aqpc::clamp_valid(nvs[k], block_size), leaders_of(table, k_blocks, slots),
                        o);
}

int done() { return static_cast<int>(cudaGetLastError()); }
int refused() { return static_cast<int>(cudaErrorInvalidValue); }

// The arguments every entry shares after its point columns.
struct Common {
  const void *mask, *nvs;
  const void *bx, *by, *bz, *crx, *cfx, *cry, *cfy, *crz, *cfz, *q0i, *q0f, *dpl, *scale, *eps_abs;
  void* table;
  int64_t k_blocks, block_size, slots, dimx, dimy, dimz;
  void* stream;
};

bool sizes_ok(const Common& c) {
  const int64_t dim_max = int64_t{1} << 23;
  return c.k_blocks <= aqpc::kMaxGridY && c.slots >= 1 && (c.slots & (c.slots - 1)) == 0 &&
         c.dimx >= 1 && c.dimy >= 1 && c.dimz >= 1 && c.dimx <= dim_max && c.dimy <= dim_max &&
         c.dimz <= dim_max;
}

Tables tables_of(const Common& c) {
  Tables t;
  const void* b[3] = {c.bx, c.by, c.bz};
  const void* cr[3] = {c.crx, c.cry, c.crz};
  const void* cf[3] = {c.cfx, c.cfy, c.cfz};
  const int64_t dim[3] = {c.dimx, c.dimy, c.dimz};
  for (int i = 0; i < 3; ++i) {
    t.b[i] = static_cast<const int32_t*>(b[i]);
    t.cr[i] = static_cast<const int32_t*>(cr[i]);
    t.cf[i] = static_cast<const float*>(cf[i]);
    t.dim[i] = static_cast<int>(dim[i]);
  }
  t.q0i = static_cast<const int32_t*>(c.q0i);
  t.q0f = static_cast<const float*>(c.q0f);
  t.dpl = static_cast<const float*>(c.dpl);
  t.scale = static_cast<const float*>(c.scale);
  t.eps_abs = static_cast<const float*>(c.eps_abs);
  return t;
}

MaskOut mask_out(const Common& c, void* bits, void* counts, void* chunks) {
  return MaskOut{static_cast<uint32_t*>(bits), static_cast<int32_t*>(counts),
                 static_cast<int32_t*>(chunks), aqpc::mask_words(c.block_size),
                 aqpc::mask_chunks(c.block_size)};
}

// Pass 1 clears the table first: keys and values to all ones.
bool clear_table(const Common& c) {
  return cudaMemsetAsync(c.table, 0xff, static_cast<size_t>(c.k_blocks) * c.slots * 12,
                         static_cast<cudaStream_t>(c.stream)) == cudaSuccess;
}

template <bool Second>
int launch_raw(const void* xs, const void* ys, const void* zs, const Common& c, const MaskOut& o) {
  if (c.k_blocks <= 0 || c.block_size <= 0) return done();
  if (!sizes_ok(c)) return refused();
  if (!Second && !clear_table(c)) return done();
  const dim3 grid(static_cast<unsigned>(o.n_chunks), static_cast<unsigned>(c.k_blocks));
  density_raw_kernel<Second><<<grid, kThreads, 0, static_cast<cudaStream_t>(c.stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(zs), static_cast<const uint32_t*>(c.mask),
      static_cast<const int32_t*>(c.nvs), tables_of(c), c.table, c.slots, o, c.k_blocks,
      c.block_size);
  return done();
}

template <bool Second>
int launch_packed(const void* xp, const void* yp, const void* zp, const void* bases,
                  int64_t kx, int64_t ky, int64_t kz, const Common& c, const MaskOut& o) {
  if (c.k_blocks <= 0 || c.block_size <= 0) return done();
  if (!sizes_ok(c) || !aqpc::width_ok(kx, 32, c.block_size) ||
      !aqpc::width_ok(ky, 32, c.block_size) || !aqpc::width_ok(kz, 32, c.block_size))
    return refused();
  if (!Second && !clear_table(c)) return done();
  const dim3 grid(static_cast<unsigned>(o.n_chunks), static_cast<unsigned>(c.k_blocks));
  density_packed_kernel<Second><<<grid, kThreads, 0, static_cast<cudaStream_t>(c.stream)>>>(
      aqpc::make_planes(xp, kx, c.block_size), aqpc::make_planes(yp, ky, c.block_size),
      aqpc::make_planes(zp, kz, c.block_size), static_cast<const int32_t*>(bases),
      static_cast<const uint32_t*>(c.mask), static_cast<const int32_t*>(c.nvs), tables_of(c),
      c.table, c.slots, o, c.k_blocks, c.block_size);
  return done();
}

}  // namespace

// Every entry: the point columns, mask (K, ceil(B/32)) uint32 predicate
// words, nvs (K,) int32, the file's tables (bx, by, bz: dim + 2 int32; crx,
// cfx, cry, cfy, crz, cfz: dim int32 / f32; q0i (3,) int32; q0f, dpl, scale
// (3,) f32; eps_abs (1,) f32), table (K * slots * 12 bytes), the outputs of
// pass 2 (bits, counts zeroed by the caller, chunks, as in mask_bits.cu),
// then K, B, slots (a power of two), dimx, dimy, dimz (and widths), then the
// stream. Returns cudaGetLastError(), or cudaErrorInvalidValue for sizes
// the kernels refuse.
#define AQPC_DENSITY_TABLE_PARAMS                                                           \
  const void *bx, const void *by, const void *bz, const void *crx, const void *cfx,          \
      const void *cry, const void *cfy, const void *crz, const void *cfz, const void *q0i,   \
      const void *q0f, const void *dpl, const void *scale, const void *eps_abs
#define AQPC_DENSITY_COMMON                                                                  \
  Common {                                                                                   \
    mask, nvs, bx, by, bz, crx, cfx, cry, cfy, crz, cfz, q0i, q0f, dpl, scale, eps_abs,      \
        table, k_blocks, block_size, slots, dimx, dimy, dimz, stream                         \
  }

// xs, ys, zs: (K, B) int32.
extern "C" int aqpc_density_leaders(const void* xs, const void* ys, const void* zs,
                                    const void* mask, const void* nvs, AQPC_DENSITY_TABLE_PARAMS,
                                    void* table, int64_t k_blocks, int64_t block_size,
                                    int64_t slots, int64_t dimx, int64_t dimy, int64_t dimz,
                                    void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_raw<false>(xs, ys, zs, c, mask_out(c, nullptr, nullptr, nullptr));
}

extern "C" int aqpc_density_candidates(const void* xs, const void* ys, const void* zs,
                                       const void* mask, const void* nvs,
                                       AQPC_DENSITY_TABLE_PARAMS, void* table, void* bits,
                                       void* counts, void* chunks, int64_t k_blocks,
                                       int64_t block_size, int64_t slots, int64_t dimx,
                                       int64_t dimy, int64_t dimz, void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_raw<true>(xs, ys, zs, c, mask_out(c, bits, counts, chunks));
}

// xp, yp, zp: (K, row width) u8 plane stacks at kx, ky, kz bits in [0, 32];
// bases: (K, 3) int32, added to the residuals (wrapping).
extern "C" int aqpc_density_leaders_packed(const void* xp, const void* yp, const void* zp,
                                           const void* bases, const void* mask, const void* nvs,
                                           AQPC_DENSITY_TABLE_PARAMS, void* table,
                                           int64_t k_blocks, int64_t block_size, int64_t slots,
                                           int64_t dimx, int64_t dimy, int64_t dimz, int64_t kx,
                                           int64_t ky, int64_t kz, void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_packed<false>(xp, yp, zp, bases, kx, ky, kz, c,
                              mask_out(c, nullptr, nullptr, nullptr));
}

extern "C" int aqpc_density_candidates_packed(const void* xp, const void* yp, const void* zp,
                                              const void* bases, const void* mask,
                                              const void* nvs, AQPC_DENSITY_TABLE_PARAMS,
                                              void* table, void* bits, void* counts,
                                              void* chunks, int64_t k_blocks, int64_t block_size,
                                              int64_t slots, int64_t dimx, int64_t dimy,
                                              int64_t dimz, int64_t kx, int64_t ky, int64_t kz,
                                              void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_packed<true>(xp, yp, zp, bases, kx, ky, kz, c,
                             mask_out(c, bits, counts, chunks));
}

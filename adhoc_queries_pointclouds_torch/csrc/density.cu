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
//     a certified point lowers the d2 of its cell's slot in the block's
//     region of the leaders table.
//   pass 2, density_candidates[_packed]: recomputes cell and d2 (cheaper
//     than storing 16 bytes a point), reads the cell's leader and keeps the
//     point if d2 <= (leader + 1e-5 * leader) + eps_abs; uncertified points
//     are kept wholesale. The result is a bit mask with per-chunk and
//     per-block counts in the layout of collect.cuh, which compact_bits.cu
//     turns into ascending indices.
//
// The table: K regions of `slots` slots (a power of two), every byte set to
// ones by the pass 1 entry (one cudaMemsetAsync of exactly those slots,
// inside the kernel's time). A key is the cell's linear index
// (cz * dimy + cy) * dimx + cx. The caller picks the slot layout from the
// grid's cell count (ops/density.py slot_bytes) and the kernels take it as
// a template argument; either layout puts a slot in one 32-byte sector:
//   word, 8 bytes (grids of fewer than 2^32 cells, so key < 0xffffffff):
//     key << 32 | d2 bits. A thread claims an empty slot with one 64-bit
//     atomicCAS of its whole word; a 64-bit atomicMin lowers a slot of the
//     same key, exact because the high halves are equal. Pass 2 reads one
//     word and compares its high half with the key.
//   wide, 16 bytes (larger grids): uint64 key, uint32 d2 bits, pad. The
//     all-ones key is "empty": the one cell that could have it (the last of
//     a grid of exactly 2^64 cells) is uncertified, so its points survive.
// A d2 is >= +0, so its bits order as the float does; all ones is above
// every d2. A NaN d2 never enters the table: such a point is uncertified.
// Where the grid has no more cells than slots, a key's slot is the key
// itself (direct: no probe, and a word slot needs no claim, only the
// atomicMin); else mix(key), then linear probing. The caller sizes a region
// at two slots or more per cell the block can hold, the fewer of its
// predicate hits and the grid's cells (table_slots). If a hashed region
// fills all the same, pass 1 drops the cell and pass 2 keeps every point
// whose cell it does not find, so the candidates stay a superset.
//
// Arithmetic equals the plain PyTorch version bit for bit: __fsub_rn,
// __fmul_rn and __fadd_rn keep each product and sum rounded on its own (no
// fused multiply-add), the two wrapping subtractions run unsigned, and the
// estimate is clamped to [-1, dim] as a float (NaN to -1) before it is
// truncated.
//
// What bounds it: device-memory reads of x, y and z (12 bytes a point, or
// the planes' bytes) in both passes, plus one bit a point in and out; the
// leaders add 8 bytes an occupied cell. On the card the per-point cell
// arithmetic weighs as much: about 150 integer and float instructions and
// chains of dependent boundary-table loads through L1, per point and pass.
// The table's probes cost little once they hit L2: a full block's region
// is at most 2^22 word slots, 32 MB of the 50 MB.
//
// What the design does about it:
//   - one launch of a persistent grid (as many CTAs as the card holds)
//     that walks the (block, 2048-row tile) pairs in block order, so the
//     CTAs in flight work on one block's region (two where they cross into
//     the next) and it stays in L2 while they do. Coordinates and mask are
//     read with streaming loads (__ldcs, evict first) so that they do not
//     push it out. (An L2 access-policy window would need a device-wide
//     persisting-L2 carve-out, cudaLimitPersistingL2CacheSize: state beyond
//     this call.) Pass 2 adds each tile's count to its chunk's with an
//     integer atomic, so the chunks of collect.cuh need not be CTAs.
//   - a thread takes 8 consecutive points (two 16-byte loads per raw
//     column, or aqpc::unpack8 of the planes, base added), skips loads for
//     groups with no predicate hit, and computes the 8 cells before it uses
//     any, so that their chains of table loads overlap; a warp whose groups
//     have no hit skips the arithmetic.
//   - pass 1 folds a thread's run of consecutive points of one cell in
//     registers. A run that ends inside the thread's 8 points lowers its
//     slot at once; the last run, which can go on in the next lanes, meets
//     the warp's: where the 32 last runs are of one cell (a cell with over
//     256 hits in file order) one lane does the min of all, with one
//     atomic. A direct word slot is read before its atomicMin, which is
//     skipped where the slot holds a lower word already: under contention
//     most points are no new least d2.
//   - pass 2 reuses a thread's last lookup for its next point of the same
//     cell; lanes that look up one slot in one step share the load (the
//     card merges a warp's equal addresses). Four lanes OR their 8-bit
//     results into a mask word with two shuffles.
//   Measured (PERF.md, section 6; tools/density_bench.py --match builds
//   the variant, AQPC_DENSITY_MATCH=1): grouping the lanes of each key with
//   __match_any_sync at each of the 8 points of both passes, one table
//   access a group, costs more than it saves.
#include <climits>

#ifndef AQPC_DENSITY_MATCH
#define AQPC_DENSITY_MATCH 0
#endif

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
// an empty slot's word or key; a lane's "no key"
constexpr unsigned long long kEmpty = ~0ull;
// d2 bits of "no leader": a NaN pattern, so never a leader
constexpr unsigned kNoLeader = ~0u;
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
  c.certified = okx && oky && okz && !isnan(c.d2) && c.key != kEmpty;
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

// One block's region of the leaders table; Wide: 16-byte slots.
template <bool Wide>
struct Region {
  unsigned long long* slots;  // slots x (Wide ? 2 : 1) uint64
  unsigned long long last;    // slots - 1
  bool direct;                // the grid has no more cells than slots

  __device__ __forceinline__ unsigned long long first(unsigned long long key) const {
    return direct ? key : mix(key) & last;
  }
  __device__ __forceinline__ unsigned long long* at(unsigned long long h) const {
    return slots + (Wide ? 2 * h : h);
  }
  // The region of block k, this being the table's first.
  __device__ __forceinline__ Region block(int64_t k) const {
    return Region{slots + k * static_cast<int64_t>(last + 1) * (Wide ? 2 : 1), last, direct};
  }
};

// Lowers the d2 bits of key's slot to d2, claiming an empty slot by linear
// probing. A stale read can only show "empty" for a slot that holds a key
// by now, and the compare-and-swap then returns that key's word.
template <bool Wide>
__device__ __forceinline__ void leader_min(const Region<Wide>& t, unsigned long long key,
                                           unsigned d2) {
  unsigned long long h = t.first(key);
  if constexpr (!Wide) {
    const unsigned long long word = key << 32 | d2;
    if (t.direct) {
      // only this key's words land here, and empty is above them; a slot
      // that holds a lower word already (a stale read shows a higher one,
      // never a lower) needs no atomic
      if (*t.at(h) > word) atomicMin(t.at(h), word);
      return;
    }
    for (unsigned long long n = 0; n <= t.last; ++n) {
      unsigned long long cur = __ldcg(t.at(h));
      if (cur == kEmpty) {
        cur = atomicCAS(t.at(h), kEmpty, word);
        if (cur == kEmpty) return;
      }
      if (cur >> 32 == key) {
        if (cur > word) atomicMin(t.at(h), word);
        return;
      }
      h = (h + 1) & t.last;
    }
  } else {
    for (unsigned long long n = 0; n <= t.last; ++n) {
      unsigned long long* slot = t.at(h);
      unsigned long long cur = __ldcg(slot);
      if (cur == kEmpty) {
        cur = atomicCAS(slot, kEmpty, key);
        if (cur == kEmpty) cur = key;
      }
      if (cur == key) {
        atomicMin(reinterpret_cast<unsigned*>(slot + 1), d2);
        return;
      }
      h = (h + 1) & t.last;
    }
  }
}

// The d2 bits of key's leader, or kNoLeader if the table does not hold
// the cell.
template <bool Wide>
__device__ __forceinline__ unsigned leader_of(const Region<Wide>& t, unsigned long long key) {
  unsigned long long h = t.first(key);
  for (unsigned long long n = 0; n <= t.last; ++n) {
    if constexpr (!Wide) {
      const unsigned long long cur = __ldg(t.at(h));
      if (cur >> 32 == key) return static_cast<unsigned>(cur);
      if (cur == kEmpty) return kNoLeader;
    } else {
      const ulonglong2 cur = *reinterpret_cast<const ulonglong2*>(t.at(h));
      if (cur.x == key) return static_cast<unsigned>(cur.y);
      if (cur.x == kEmpty) return kNoLeader;
    }
    h = (h + 1) & t.last;
  }
  return kNoLeader;
}

// The lanes' last runs, for the whole warp (every lane calls it). Where
// every lane's key is one cell's, the lanes meet: __reduce_min_sync takes
// their least d2 and one lane lowers the slot. Else each lane lowers its
// own. A lane whose key is kEmpty has nothing to add.
template <bool Wide>
__device__ __forceinline__ void warp_min(const Region<Wide>& t, unsigned long long key,
                                         unsigned d2) {
  const unsigned some = __ballot_sync(kFull, key != kEmpty);
  if (!some) return;
  const int first = __ffs(some) - 1;
  const unsigned long long one = __shfl_sync(kFull, key, first);
  if (__all_sync(kFull, key == one || key == kEmpty)) {
    const unsigned least = __reduce_min_sync(kFull, key == kEmpty ? kNoLeader : d2);
    if (static_cast<int>(threadIdx.x & 31) == first) leader_min(t, key, least);
  } else if (key != kEmpty) {
    leader_min(t, key, d2);
  }
}

// The cells of a lane's 8 points, all computed before any of them is used
// so that their 24 chains of table loads overlap: key[i] and the bits of
// d2[i], and bit i of the result set if point i is a hit (bit i of m) and
// certified. Points that are no hit are computed all the same (their
// coordinates are 0 or another point's; every index stays in its table).
__device__ __forceinline__ unsigned cells8(const Grid& g, unsigned m, const int (&vx)[8],
                                           const int (&vy)[8], const int (&vz)[8],
                                           unsigned long long (&key)[8], unsigned (&d2)[8]) {
  unsigned ok = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const Cell c = cell_of(g, vx[i], vy[i], vz[i]);
    key[i] = c.key;
    d2[i] = __float_as_uint(c.d2);
    ok |= static_cast<unsigned>(c.certified) << i;
  }
  return ok & m;
}

// Pass 1 over a lane's 8 points (bit i of m: point i is a hit). A run of
// consecutive points of one cell is folded in registers; a run that ends
// inside the lane's points lowers its slot at once, and the lane's last
// run, the one that can go on in the next lanes, meets the warp's.
// Built with AQPC_DENSITY_MATCH=1 (tools/density_bench.py --match), the
// variant that was measured against it instead: at each of the 8 points
// the lanes of one key meet (__match_any_sync), __reduce_min_sync takes
// their least d2 and the group's first lane lowers the slot.
template <bool Wide>
__device__ __forceinline__ void leaders8(const Grid& g, const Region<Wide>& t, unsigned m,
                                         const int (&vx)[8], const int (&vy)[8],
                                         const int (&vz)[8]) {
  unsigned long long key[8];
  unsigned d2[8];
  const unsigned ok = cells8(g, m, vx, vy, vz, key, d2);
#if AQPC_DENSITY_MATCH
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned long long k = (ok >> i) & 1u ? key[i] : kEmpty;
    const unsigned peers = __match_any_sync(kFull, k);
    const unsigned least = __reduce_min_sync(peers, d2[i]);
    if (k != kEmpty && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
      leader_min(t, k, least);
  }
#else
  unsigned long long run = kEmpty;
  unsigned run_d2 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if ((ok >> i) & 1u) {
      if (key[i] == run) {
        run_d2 = min(run_d2, d2[i]);
      } else {
        if (run != kEmpty) leader_min(t, run, run_d2);
        run = key[i];
        run_d2 = d2[i];
      }
    }
  }
  warp_min(t, run, run_d2);
#endif
}

// Pass 2 over a lane's 8 points: the bits of those kept. A lane's next
// point of the cell it looked up last takes the same leader; lanes that
// look up one slot in one step share the load (the card merges equal
// addresses of a warp's load). The AQPC_DENSITY_MATCH=1 variant: at each
// point the lanes of one key meet, the group's first lane looks it up and
// shuffles the leader to the others.
template <bool Wide>
__device__ __forceinline__ unsigned candidates8(const Grid& g, const Region<Wide>& t,
                                                unsigned m, const int (&vx)[8],
                                                const int (&vy)[8], const int (&vz)[8]) {
  unsigned long long key[8];
  unsigned d2[8];
  const unsigned ok = cells8(g, m, vx, vy, vz, key, d2);
  unsigned long long prev = kEmpty;  // the cell this lane looked up last
  unsigned lead = kNoLeader;         // its leader's d2 bits
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool hit = (m >> i) & 1u;
    const bool certified = (ok >> i) & 1u;
#if AQPC_DENSITY_MATCH
    const unsigned long long k = certified ? key[i] : kEmpty;
    const unsigned peers = __match_any_sync(kFull, k);
    const int first = __ffs(peers) - 1;
    lead = k != kEmpty && static_cast<int>(threadIdx.x & 31) == first ? leader_of(t, k)
                                                                        : kNoLeader;
    lead = __shfl_sync(peers, lead, first);
#else
    if (certified && key[i] != prev) {
      prev = key[i];
      lead = leader_of(t, prev);
    }
#endif
    if (hit) {
      // kept unless its cell has a leader that beats it by the margin
      bool k = true;
      if (certified && lead != kNoLeader) {
        const float l = __uint_as_float(lead);
        k = __uint_as_float(d2[i]) <= __fadd_rn(__fadd_rn(l, __fmul_rn(kEpsRel, l)), g.eps_abs);
      }
      keep |= static_cast<unsigned>(k) << i;
    }
  }
  return keep;
}

// Raw (K, B) int32 columns, read with streaming loads.
struct RawSrc {
  const int32_t *x, *y, *z;
  bool aligned;  // rows on 16-byte boundaries

  __device__ __forceinline__ static void load(const int32_t* col, bool wide, int valid,
                                              int (&v)[8]) {
    if (wide) {
      const int4 lo = __ldcs(reinterpret_cast<const int4*>(col));
      const int4 hi = __ldcs(reinterpret_cast<const int4*>(col) + 1);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = i < valid ? __ldcs(col + i) : 0;
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
    aqpc::unpack8<true>(p.row, block_size, p.nbytes, p.nbits, g, valid, p.aligned, r);
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

// A tile is kCtaWords mask words (2048 rows), a quarter of a chunk of
// collect.cuh: one pass of a CTA's warps.
constexpr int64_t kCtaWords = 8 * kWarps;
static_assert(kChunkWords % kCtaWords == 0, "a chunk is whole tiles");

__host__ __device__ __forceinline__ int64_t tiles_per_block(const MaskOut& o) {
  return (o.n_words + kCtaWords - 1) / kCtaWords;
}

// Tile x of block k: lane l of warp v takes the 8 points of group
// 4 * wb + l, wb = 64 * x + 8 * v, so the warp covers mask words
// wb..wb+7. Pass 1 (Second false) fills the leaders; pass 2 writes the
// candidates' words and adds the tile's count to its chunk's (zeroed by
// the entry) and to the block's. Every thread of the CTA calls it.
template <bool Second, bool Wide, class Src>
__device__ __forceinline__ void density_tile(const Src& src, const Grid& g,
                                             const uint32_t* __restrict__ mask, int64_t nv,
                                             const Region<Wide>& t, const MaskOut& o, int64_t k,
                                             int64_t x) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t wb = x * kCtaWords + 8 * warp;
  int count = 0;
  if (wb < o.n_words) {
    const int64_t grp = 4 * wb + lane;
    const int64_t w = wb + (lane >> 2);
    const int64_t left = nv - 8 * grp;
    const int valid = left >= 8 ? 8 : (left <= 0 ? 0 : static_cast<int>(left));
    unsigned m = 0;
    if (valid) m = (__ldcs(mask + w) >> (8 * (lane & 3))) & aqpc::group_valid_mask(valid);
    unsigned keep = 0;
    if (__any_sync(kFull, m)) {
      int vx[8] = {}, vy[8] = {}, vz[8] = {};
      if (m) src.load8(grp, valid, vx, vy, vz);
      if constexpr (Second)
        keep = candidates8(g, t, m, vx, vy, vz);
      else
        leaders8(g, t, m, vx, vy, vz);
    }
    if constexpr (Second) {
      unsigned word = keep << (8 * (lane & 3));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      if ((lane & 3) == 0 && w < o.n_words) {
        o.bits[k * o.n_words + w] = word;
        count = __popc(word);
      }
    }
  }
  if constexpr (Second) {
    count = aqpc::cta_sum(count);
    if (threadIdx.x == 0 && count) {
      atomicAdd(o.chunks + k * o.n_chunks + x * kCtaWords / kChunkWords, count);
      atomicAdd(o.counts + k, count);
    }
    __syncthreads();  // cta_sum's shared sums are free again
  }
}

// A persistent grid: CTA b takes tiles b, b + gridDim.x, ... of the K
// blocks' tiles in block order, so the CTAs in flight work on one block
// (two where they cross into the next).
template <bool Second, bool Wide>
__global__ void __launch_bounds__(kThreads)
density_raw_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                   const int32_t* __restrict__ zs, const uint32_t* __restrict__ mask,
                   const int32_t* __restrict__ nvs, Tables tables, Region<Wide> t, MaskOut o,
                   int64_t k_blocks, int64_t block_size) {
  const Grid g = load_grid(tables);
  const int64_t tiles = tiles_per_block(o);
  for (int64_t item = blockIdx.x; item < k_blocks * tiles; item += gridDim.x) {
    const int64_t k = item / tiles;
    const int32_t* x = xs + k * block_size;
    const int32_t* y = ys + k * block_size;
    const int32_t* z = zs + k * block_size;
    const RawSrc src{x, y, z,
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                      reinterpret_cast<uintptr_t>(z)) % 16 == 0};
    density_tile<Second>(src, g, mask + k * o.n_words, aqpc::clamp_valid(nvs[k], block_size),
                         t.block(k), o, k, item - k * tiles);
  }
}

template <bool Second, bool Wide>
__global__ void __launch_bounds__(kThreads)
density_packed_kernel(Planes ax, Planes ay, Planes az, const int32_t* __restrict__ bases,
                      const uint32_t* __restrict__ mask, const int32_t* __restrict__ nvs,
                      Tables tables, Region<Wide> t, MaskOut o, int64_t k_blocks,
                      int64_t block_size) {
  const Grid g = load_grid(tables);
  const int64_t tiles = tiles_per_block(o);
  for (int64_t item = blockIdx.x; item < k_blocks * tiles; item += gridDim.x) {
    const int64_t k = item / tiles;
    const PackedSrc src{aqpc::plane_row(ax, k, block_size), aqpc::plane_row(ay, k, block_size),
                        aqpc::plane_row(az, k, block_size),
                        {static_cast<unsigned>(bases[3 * k]),
                         static_cast<unsigned>(bases[3 * k + 1]),
                         static_cast<unsigned>(bases[3 * k + 2])},
                        block_size};
    density_tile<Second>(src, g, mask + k * o.n_words, aqpc::clamp_valid(nvs[k], block_size),
                         t.block(k), o, k, item - k * tiles);
  }
}

int done() { return static_cast<int>(cudaGetLastError()); }
int refused() { return static_cast<int>(cudaErrorInvalidValue); }

// The arguments every entry shares after its point columns.
struct Common {
  const void *mask, *nvs;
  const void *bx, *by, *bz, *crx, *cfx, *cry, *cfy, *crz, *cfz, *q0i, *q0f, *dpl, *scale, *eps_abs;
  void* table;
  int64_t k_blocks, block_size, slots, slot_bytes, dimx, dimy, dimz;
  void* stream;
};

// Whether the grid has at most n cells (dims in [1, 2^23], so dimx * dimy
// fits).
bool cells_at_most(const Common& c, int64_t n) {
  const int64_t xy = c.dimx * c.dimy;
  return xy <= n && c.dimz <= n / xy;
}

bool sizes_ok(const Common& c) {
  const int64_t dim_max = int64_t{1} << 23;
  return c.slots >= 1 && (c.slots & (c.slots - 1)) == 0 &&
         c.dimx >= 1 && c.dimy >= 1 && c.dimz >= 1 && c.dimx <= dim_max && c.dimy <= dim_max &&
         c.dimz <= dim_max &&
         (c.slot_bytes == 16 || (c.slot_bytes == 8 && cells_at_most(c, (int64_t{1} << 32) - 1)));
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

template <bool Wide>
Region<Wide> table_of(const Common& c) {
  return Region<Wide>{static_cast<unsigned long long*>(c.table),
                      static_cast<unsigned long long>(c.slots - 1), cells_at_most(c, c.slots)};
}

// Pass 1 first sets every byte of the K regions to ones, pass 2 zeroes the
// chunk counts; then one launch of `kernel` over the (block, tile) pairs,
// on at most as many CTAs as the card holds at once.
template <bool Second, class Kernel, class... Args>
int launch(const Common& c, const MaskOut& o, Kernel kernel, Args... args) {
  const auto stream = static_cast<cudaStream_t>(c.stream);
  const cudaError_t cleared =
      Second ? cudaMemsetAsync(o.chunks, 0, static_cast<size_t>(c.k_blocks * o.n_chunks) * 4,
                               stream)
             : cudaMemsetAsync(c.table, 0xff,
                               static_cast<size_t>(c.k_blocks * c.slots * c.slot_bytes), stream);
  if (cleared != cudaSuccess) return done();
  const int64_t items = c.k_blocks * tiles_per_block(o);
  const int64_t resident = aqpc::resident_ctas(kernel);
  const unsigned grid = static_cast<unsigned>(items < resident ? items : resident);
  kernel<<<grid, kThreads, 0, stream>>>(args..., o, c.k_blocks, c.block_size);
  return done();
}

template <bool Second, bool Wide>
int raw_blocks(const void* xs, const void* ys, const void* zs, const Common& c,
               const MaskOut& o) {
  return launch<Second>(c, o, density_raw_kernel<Second, Wide>, static_cast<const int32_t*>(xs),
                        static_cast<const int32_t*>(ys), static_cast<const int32_t*>(zs),
                        static_cast<const uint32_t*>(c.mask), static_cast<const int32_t*>(c.nvs),
                        tables_of(c), table_of<Wide>(c));
}

template <bool Second>
int launch_raw(const void* xs, const void* ys, const void* zs, const Common& c, const MaskOut& o) {
  if (c.k_blocks <= 0 || c.block_size <= 0) return done();
  if (!sizes_ok(c)) return refused();
  return c.slot_bytes == 16 ? raw_blocks<Second, true>(xs, ys, zs, c, o)
                            : raw_blocks<Second, false>(xs, ys, zs, c, o);
}

template <bool Second, bool Wide>
int packed_blocks(const Planes& ax, const Planes& ay, const Planes& az, const void* bases,
                  const Common& c, const MaskOut& o) {
  return launch<Second>(c, o, density_packed_kernel<Second, Wide>, ax, ay, az,
                        static_cast<const int32_t*>(bases), static_cast<const uint32_t*>(c.mask),
                        static_cast<const int32_t*>(c.nvs), tables_of(c), table_of<Wide>(c));
}

template <bool Second>
int launch_packed(const void* xp, const void* yp, const void* zp, const void* bases,
                  int64_t kx, int64_t ky, int64_t kz, const Common& c, const MaskOut& o) {
  if (c.k_blocks <= 0 || c.block_size <= 0) return done();
  if (!sizes_ok(c) || !aqpc::width_ok(kx, 32, c.block_size) ||
      !aqpc::width_ok(ky, 32, c.block_size) || !aqpc::width_ok(kz, 32, c.block_size))
    return refused();
  const Planes ax = aqpc::make_planes(xp, kx, c.block_size);
  const Planes ay = aqpc::make_planes(yp, ky, c.block_size);
  const Planes az = aqpc::make_planes(zp, kz, c.block_size);
  return c.slot_bytes == 16 ? packed_blocks<Second, true>(ax, ay, az, bases, c, o)
                            : packed_blocks<Second, false>(ax, ay, az, bases, c, o);
}

}  // namespace

// Every entry: the point columns, mask (K, ceil(B/32)) uint32 predicate
// words, nvs (K,) int32, the file's tables (bx, by, bz: dim + 2 int32; crx,
// cfx, cry, cfy, crz, cfz: dim int32 / f32; q0i (3,) int32; q0f, dpl, scale
// (3,) f32; eps_abs (1,) f32), table (K * slots * slot_bytes bytes), the
// outputs of pass 2 (bits, counts zeroed by the caller, chunks, as in
// mask_bits.cu), then K, B, slots (a power of two), slot_bytes (8, for
// grids of fewer than 2^32 cells, or 16), dimx, dimy, dimz (and widths),
// then the stream. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// sizes the kernels refuse.
#define AQPC_DENSITY_TABLE_PARAMS                                                           \
  const void *bx, const void *by, const void *bz, const void *crx, const void *cfx,          \
      const void *cry, const void *cfy, const void *crz, const void *cfz, const void *q0i,   \
      const void *q0f, const void *dpl, const void *scale, const void *eps_abs
#define AQPC_DENSITY_COMMON                                                                  \
  Common {                                                                                   \
    mask, nvs, bx, by, bz, crx, cfx, cry, cfy, crz, cfz, q0i, q0f, dpl, scale, eps_abs,      \
        table, k_blocks, block_size, slots, slot_bytes, dimx, dimy, dimz, stream             \
  }

// xs, ys, zs: (K, B) int32.
extern "C" int aqpc_density_leaders(const void* xs, const void* ys, const void* zs,
                                    const void* mask, const void* nvs, AQPC_DENSITY_TABLE_PARAMS,
                                    void* table, int64_t k_blocks, int64_t block_size,
                                    int64_t slots, int64_t slot_bytes, int64_t dimx, int64_t dimy,
                                    int64_t dimz, void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_raw<false>(xs, ys, zs, c, mask_out(c, nullptr, nullptr, nullptr));
}

extern "C" int aqpc_density_candidates(const void* xs, const void* ys, const void* zs,
                                       const void* mask, const void* nvs,
                                       AQPC_DENSITY_TABLE_PARAMS, void* table, void* bits,
                                       void* counts, void* chunks, int64_t k_blocks,
                                       int64_t block_size, int64_t slots, int64_t slot_bytes,
                                       int64_t dimx, int64_t dimy, int64_t dimz, void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_raw<true>(xs, ys, zs, c, mask_out(c, bits, counts, chunks));
}

// xp, yp, zp: (K, row width) u8 plane stacks at kx, ky, kz bits in [0, 32];
// bases: (K, 3) int32, added to the residuals (wrapping).
extern "C" int aqpc_density_leaders_packed(const void* xp, const void* yp, const void* zp,
                                           const void* bases, const void* mask, const void* nvs,
                                           AQPC_DENSITY_TABLE_PARAMS, void* table,
                                           int64_t k_blocks, int64_t block_size, int64_t slots,
                                           int64_t slot_bytes, int64_t dimx, int64_t dimy,
                                           int64_t dimz, int64_t kx, int64_t ky, int64_t kz,
                                           void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_packed<false>(xp, yp, zp, bases, kx, ky, kz, c,
                              mask_out(c, nullptr, nullptr, nullptr));
}

extern "C" int aqpc_density_candidates_packed(const void* xp, const void* yp, const void* zp,
                                              const void* bases, const void* mask,
                                              const void* nvs, AQPC_DENSITY_TABLE_PARAMS,
                                              void* table, void* bits, void* counts,
                                              void* chunks, int64_t k_blocks, int64_t block_size,
                                              int64_t slots, int64_t slot_bytes, int64_t dimx,
                                              int64_t dimy, int64_t dimz, int64_t kx, int64_t ky,
                                              int64_t kz, void* stream) {
  const Common c = AQPC_DENSITY_COMMON;
  return launch_packed<true>(xp, yp, zp, bases, kx, ky, kz, c,
                             mask_out(c, bits, counts, chunks));
}

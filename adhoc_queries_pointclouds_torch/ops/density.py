"""Max-density grid sampling: keep the point closest to its cell centre.

The counterpart of adhoc_queries_pointclouds_tpu/ops/density.py, bit-exact
to the reference SparseGrid's f64 semantics (query/src/grid_sampling.rs:
18-105). The work splits as there:

  device (f32/int32): each point gets its cell from an f32 estimate refined
    against exact integer boundary tables (computed here on the host in
    f64, so an interior point's cell is the reference's, not an
    approximation of it). Per cell of a block the least f32 d2 is the
    leader; every point within a conservative error margin of its cell's
    leader survives as a candidate, and points the tables cannot certify
    (beyond the grid's max face, at the int32 extremes, in giant cells)
    survive wholesale. The candidate set contains every possible f64 winner.

  host (f64): GridSpec3D recomputes the reference's exact cell key and d2
    of the few candidates, and WinnerAccum merges them into the sparse
    running state with the reference's tie rule (first inserted wins).

The host half (constants, GridSpec3D, WinnerAccum, _merge_soa_py,
merge_winners_host) is copied function by function from the JAX module
(density.py:53-324, :454-594), which imports jax and so cannot be copied
whole; tests/test_torch_density.py pins it byte for byte.

The device half replaces _density_candidates_1 (density.py:339-411) and its
callers block_density_candidates and density_candidates_multi. The JAX
version sorts each block by (cell, d2) and scans for run leaders; the
surviving set depends only on each cell's least d2, so here there is no
sort, no cap and no retry:

  density_leaders(...)      pass 1: per block, the least d2 of every cell
                            into an open-addressing table (kernel
                            density_leaders[_packed] in csrc/density.cu)
  density_candidates(...)   pass 2: the margin test against the table, into
                            a BitMask (kernel density_candidates[_packed])
  density_candidates_bits   both passes: the step's entry
  density_candidates_plain  the plain PyTorch version (torch.unique and
                            scatter_reduce_), taken for CPU tensors only
  table_slots, slot_bytes   the table's size and slot layout: slots by the
                            cells a block can hold, one 8-byte word a slot
                            below 2^32 cells
  table_leaders             the table decoded, in density_leaders_plain's
                            form

The result is a BitMask in the collect path's layout, so ops/compact.py
compact_bits turns it into ascending candidate indices. Two rules differ
from the JAX function, both on inputs no real file produces, and both keep
the candidate set a superset: a point whose wrapped distance to its cell
centre is exactly INT32_MIN is flagged (jnp.abs wraps it back to a
negative number, which passes the JAX guard), and a point whose d2 is NaN
is flagged (the JAX sort keeps the first such point of a cell only).

The kernels' launches are counted in predicate.launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.aabb import AABB
from . import predicate
from .predicate import BitMask, _check, _check_planes, _on_cuda, mask_words

I32_MAX = np.int32(2**31 - 1)
I32_MIN = np.int32(-(2**31))

WINNER_DTYPE = np.dtype(
    [
        ("key", "<u8"),  # reference bit-packed masked cell key
        ("d2", "<f8"),  # exact f64 squared distance to the cell center
        ("file_idx", "<i4"),
        ("gidx", "<i8"),
    ]
)

# conservative relative/absolute margins covering worst-case f32 error in
# the device d² (see _density_candidates_kernel); ~30x the analytic bound
EPS_REL = 1e-5


@dataclasses.dataclass(frozen=True)
class GridSpec3D:
    """Host-side grid geometry replicating SparseGrid::new exactly
    (grid_sampling.rs:18-47): dims = ceil(extent/cell) as u64 (f64 ceil),
    bits = ceil(log2(dims)) as u64, per-axis masks, <= 64 total bits."""

    bounds: AABB
    cell_size: float
    dims: tuple[int, int, int]
    bits: tuple[int, int, int]

    @staticmethod
    def create(bounds: AABB, cell_size: float) -> "GridSpec3D":
        ext = np.asarray(bounds.extent, np.float64)
        ncf = np.ceil(ext / float(cell_size))  # f64, may be 0 or negative
        dims = tuple(int(max(v, 0.0)) for v in ncf)  # `as u64` saturates
        bits = []
        for v in ncf:
            b = np.ceil(np.log2(v)) if v > 0 else -np.inf  # log2(0) = -inf
            bits.append(int(max(b, 0.0)) if np.isfinite(b) else 0)
        if sum(bits) > 64:
            raise ValueError(
                f"Too many cells ({dims[0]}*{dims[1]}*{dims[2]}) in SparseGrid! "
                "The number of cells exceeds the capacity of a u64 index!"
            )
        if max(dims) > (1 << 23):
            # device boundary tables are O(dims) int32 per axis; 8M cells on
            # one axis = 32 MiB/axis. The reference tolerates absurd dims
            # (the key wraps); we draw the line where tables stop being sane.
            raise ValueError(
                f"grid dims {dims} too large for device tables (max 2^23/axis)"
            )
        return GridSpec3D(bounds, float(cell_size), dims, tuple(bits))

    @property
    def masks(self) -> tuple[int, int, int]:
        return tuple((1 << b) - 1 for b in self.bits)

    # -- exact reference math (host f64) ------------------------------------

    def exact_cells(self, world: np.ndarray) -> np.ndarray:
        """(n, 3) world f64 -> (n, 3) uint64 unmasked cells, exactly
        replicating grid_sampling.rs:51-60 incl. `as u64` saturation."""
        bmin = np.asarray(self.bounds.min, np.float64)
        ext = np.asarray(self.bounds.extent, np.float64)
        dims_f = np.asarray(self.dims, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = (world - bmin) * dims_f / ext
        # Rust `as u64`: NaN -> 0, negative -> 0, >= 2^64 -> u64::MAX
        r = np.where(np.isnan(r), 0.0, np.maximum(r, 0.0))
        sat = r >= 2.0**64
        cells = np.where(sat, 0.0, r).astype(np.uint64)
        return np.where(sat, np.uint64(0xFFFFFFFFFFFFFFFF), cells)

    def exact_keys_d2(
        self, world: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(n, 3) world f64 -> (packed masked u64 keys, exact f64 d²).

        d² is measured to the *unmasked* cell's center — the reference masks
        only the HashMap key, not the center (grid_sampling.rs:66-83)."""
        cells = self.exact_cells(world)
        bmin = np.asarray(self.bounds.min, np.float64)
        center = (cells.astype(np.float64) + 0.5) * self.cell_size + bmin
        d = world - center
        # explicit x, y, z accumulation order: nalgebra's distance_squared
        # (the reference, grid_sampling.rs:84-95) folds components in order,
        # and einsum's pairwise/SIMD accumulation differs by 1 ulp on ~20%
        # of points — enough to flip a winner on an exact d² tie
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        mx, my, mz = (np.uint64(m) for m in self.masks)
        xb, yb = np.uint64(self.bits[0]), np.uint64(self.bits[0] + self.bits[1])
        key = (
            (cells[:, 0] & mx)
            | ((cells[:, 1] & my) << xb)
            | ((cells[:, 2] & mz) << yb)
        )
        return key, d2

    def make_winners(
        self, world: np.ndarray, gidx: np.ndarray, file_idx: int
    ) -> np.ndarray:
        """Candidate points -> WINNER_DTYPE rows with exact key/d² (host)."""
        key, d2 = self.exact_keys_d2(world)
        out = np.empty(len(world), dtype=WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = np.asarray(gidx, np.int64)
        out["file_idx"] = file_idx
        return out

    def exact_keys_d2_raw(
        self, xi: np.ndarray, yi: np.ndarray, zi: np.ndarray,
        scale, offset,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Raw int32 local coords -> (masked u64 keys, exact f64 d²).

        One fused native pass when available (aqpc_density_exact, in place
        of the ~20 numpy vector passes of the world-convert + exact_keys_d2
        chain); bit-identical numpy fallback otherwise — the
        native build uses -ffp-contract=off so every f64 op rounds exactly
        like numpy's separate ops and the reference's Rust."""
        from .. import native

        xi = np.ascontiguousarray(xi, np.int32)
        yi = np.ascontiguousarray(yi, np.int32)
        zi = np.ascontiguousarray(zi, np.int32)
        scale = np.asarray(scale, np.float64)
        offset = np.asarray(offset, np.float64)
        bmin = np.asarray(self.bounds.min, np.float64)
        ext = np.asarray(self.bounds.extent, np.float64)
        res = native.density_exact(
            xi, yi, zi, scale, offset, bmin, ext,
            np.asarray(self.dims, np.float64), self.cell_size,
            np.asarray(self.masks, np.uint64),
            self.bits[0], self.bits[0] + self.bits[1],
        )
        if res is not None:
            return res
        world = (
            np.stack([xi, yi, zi], axis=1).astype(np.float64) * scale + offset
        )
        return self.exact_keys_d2(world)

    def make_winners_raw(
        self, xi, yi, zi, scale, offset, gidx: np.ndarray, file_idx: int
    ) -> np.ndarray:
        """make_winners straight from raw int32 columns (fused native exact
        pass; no (n,3) f64 world materialization)."""
        key, d2 = self.exact_keys_d2_raw(xi, yi, zi, scale, offset)
        out = np.empty(len(key), dtype=WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = np.asarray(gidx, np.int64)
        out["file_idx"] = file_idx
        return out

    # -- device tables -------------------------------------------------------

    def file_tables(
        self,
        scale: tuple[float, float, float],
        offset: tuple[float, float, float],
    ) -> dict[str, np.ndarray]:
        key = (
            tuple(float(v) for v in self.bounds.min),
            tuple(float(v) for v in self.bounds.max),
            self.cell_size, self.dims,
            tuple(float(v) for v in scale), tuple(float(v) for v in offset),
        )
        cached = _TABLE_CACHE.get(key)
        if cached is None:
            cached = self._file_tables_impl(scale, offset)
            if len(_TABLE_CACHE) > 64:
                _TABLE_CACHE.clear()
            _TABLE_CACHE[key] = cached
        return cached

    def _file_tables_impl(
        self,
        scale: tuple[float, float, float],
        offset: tuple[float, float, float],
    ) -> dict[str, np.ndarray]:
        """Per-(file, grid) constants for the device candidate kernel
        (cached: repeated queries on the same grid+file geometry — the
        serving pattern — skip the O(dims) rebuild).

        For each axis: an exact boundary table b[0..dims+1] (int32 local
        units; b[c] is the smallest int32 p with exact f64 cell(p) >= c, so
        cell c = {p : b[c] <= p < b[c+1]} matches the reference bit-for-bit
        on the interior), plus split cell-center tables cr (int32 round) and
        cf (f32 fraction) so the device d² avoids catastrophic cancellation:
        d_local = float(p - cr[c]) - cf[c] is exact integer arithmetic plus
        two tiny f32 terms. Also the f32 affine estimate (q0i/q0f/dpl) whose
        error is < 0.5 cells for dims <= 2^23, so a +-2 correction window
        against the boundary tables always certifies interior points.
        """
        scale = np.asarray(scale, np.float64)
        offset = np.asarray(offset, np.float64)
        if np.any(scale <= 0):
            raise ValueError(f"non-positive LAS scale {scale} unsupported")
        bmin = np.asarray(self.bounds.min, np.float64)
        bmax = np.asarray(self.bounds.max, np.float64)
        ext = bmax - bmin
        dims_f = np.asarray(self.dims, np.float64)

        tables = {}
        dims_dev = []
        for ax, name in enumerate("xyz"):
            d_ax = self.dims[ax]
            dd = max(d_ax, 1)
            dims_dev.append(dd)
            b = np.empty(dd + 2, np.int64)
            b[0] = int(I32_MIN)  # `as u64` saturates r<1 (incl. negative) to cell 0
            b[dd + 1] = int(I32_MAX)  # sentinel for the +1 gather
            if d_ax == 0 or ext[ax] <= 0:
                # degenerate axis: reference r is NaN/inf -> every point cell 0
                b[1 : dd + 1] = int(I32_MAX)
            else:
                i = np.arange(1, dd + 1, dtype=np.float64)

                def r_of(p):  # exact reference r at integer local coords p
                    w = p * scale[ax] + offset[ax]
                    return (w - bmin[ax]) * dims_f[ax] / ext[ax]

                approx = (i * ext[ax] / dims_f[ax] + bmin[ax] - offset[ax]) / scale[ax]
                p = np.ceil(approx)
                # correct the f64-approximate inverse to the true threshold
                for _ in range(8):
                    too_high = r_of(p - 1) >= i
                    if not too_high.any():
                        break
                    p = np.where(too_high, p - 1, p)
                for _ in range(8):
                    too_low = r_of(p) < i
                    if not too_low.any():
                        break
                    p = np.where(too_low, p + 1, p)
                bad = (r_of(p) < i) | (r_of(p - 1) >= i)
                if bad.any():  # extreme exponents: bisection fallback
                    lo = np.full_like(p, float(I32_MIN))
                    hi = np.full_like(p, float(I32_MAX))
                    for _ in range(34):
                        mid = np.floor((lo + hi) / 2)
                        ge = r_of(mid) >= i
                        hi = np.where(ge, mid, hi)
                        lo = np.where(ge, lo, mid)
                    p = np.where(bad, hi, p)
                b[1 : dd + 1] = np.clip(p, int(I32_MIN), int(I32_MAX)).astype(np.int64)
            tables[f"b{name}"] = b.astype(np.int32)

            # split center tables for cells 0..dd-1
            c = np.arange(dd, dtype=np.float64)
            center_w = (c + 0.5) * self.cell_size + bmin[ax]
            center_l = (center_w - offset[ax]) / scale[ax]
            cr = np.clip(np.round(center_l), int(I32_MIN) + 1, int(I32_MAX) - 1)
            tables[f"cr{name}"] = cr.astype(np.int32)
            tables[f"cf{name}"] = (center_l - cr).astype(np.float32)

        # f32 affine estimate, grid-origin-relative so the f32 error stays
        # sub-cell: est = (float(p - q0i) - q0f) * dpl
        ext_l = ext / scale
        q0 = (bmin - offset) / scale
        q0i = np.clip(np.round(q0), int(I32_MIN) + 1, int(I32_MAX) - 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            dpl = np.where(ext_l > 0, dims_f / ext_l, 0.0)
        tables["q0i"] = q0i.astype(np.int32)
        tables["q0f"] = (q0 - q0i).astype(np.float32)
        tables["dpl"] = np.nan_to_num(dpl).astype(np.float32)
        tables["scale"] = scale.astype(np.float32)
        tables["dims"] = np.asarray(dims_dev, np.int32)
        # absolute d² slack: f32 rounding of the center fraction and scale
        tables["eps_abs"] = np.float32(3.0 * (1e-6 * self.cell_size) ** 2 + 1e-30)
        return tables


_TABLE_CACHE: dict = {}


class WinnerAccum:
    """Amortized winner-state accumulator for the engine's streaming scan.

    `merge_winners_host` lexsorts the ENTIRE running state on every call;
    called once per block (the engine's old pattern) that is O(S log S)
    per block — at paper scale (13 M winner cells over 56 blocks) the host
    spends more time re-sorting winners it already resolved than the device
    spends scanning. This accumulator batches incoming candidate rows and
    merges only when the pending batch has grown to the merged state's size
    (a logarithmic merge schedule), making the total host cost O(N log N)
    over the whole scan instead of O(B * S log S).

    Exactness: identical to folding `merge_winners_host` per block. The
    reference's tie rule is "first inserted wins" (strict < replacement,
    grid_sampling.rs:97), and the engine inserts in ascending
    (file-processing-order, gidx) — `active` iterates files in ascending
    index and blocks stream in order — so insertion order is fully encoded
    in each row's (file_seq, gidx) and the per-key minimum of
    (d2, file_seq, gidx) is insertion-schedule-invariant. `add` takes the
    file's processing sequence number explicitly so global-scope merges
    stay exact even if file_idx values were ever discovered out of order.
    """

    def __init__(self, floor: int = 1 << 19):
        # SoA state (key, d2, seq, gidx, file_idx), unique keys ascending.
        self._state: tuple[np.ndarray, ...] | None = None
        self._batches: list[np.ndarray] = []
        self._batch_seqs: list[int] = []
        self._pending = 0
        self._floor = floor

    def add(self, rows: np.ndarray, file_seq: int) -> None:
        if rows is None or len(rows) == 0:
            return
        self._batches.append(rows)
        self._batch_seqs.append(file_seq)
        self._pending += len(rows)
        state_n = 0 if self._state is None else len(self._state[0])
        if self._pending >= max(state_n, self._floor):
            self._merge()

    def _merge(self) -> None:
        from .. import native

        if not self._batches:
            return
        merged = (self._batches[0] if len(self._batches) == 1
                  else np.concatenate(self._batches))
        seq = np.concatenate([
            np.full(len(b), s, np.int32)
            for b, s in zip(self._batches, self._batch_seqs)
        ])
        self._batches = []
        self._batch_seqs = []
        self._pending = 0

        key = np.ascontiguousarray(merged["key"])
        d2 = np.ascontiguousarray(merged["d2"])
        gidx = np.ascontiguousarray(merged["gidx"])
        # single stable key sort (numpy radix for u64) replaces the old
        # 4-key lexsort; the tie rule moves into the linear native pass
        order = np.argsort(key, kind="stable").astype(np.int64, copy=False)
        widx = native.winner_dedupe(order, key, d2, seq, gidx)
        if widx is None:
            # pure-python fallback: the original lexsort semantics
            order = np.lexsort((gidx, seq, d2, key))
            key, d2, seq, gidx = key[order], d2[order], seq[order], gidx[order]
            fidx = np.ascontiguousarray(merged["file_idx"])[order]
            first = np.empty(len(key), bool)
            first[0] = True
            first[1:] = key[1:] != key[:-1]
            batch = (key[first], d2[first], seq[first], gidx[first],
                     fidx[first])
            self._state = (batch if self._state is None
                           else _merge_soa_py(self._state, batch))
            return
        batch = (key[widx], d2[widx], seq[widx], gidx[widx],
                 np.ascontiguousarray(merged["file_idx"])[widx])
        if self._state is None:
            self._state = batch
        else:
            self._state = native.winner_merge(self._state, batch)

    def result(self) -> np.ndarray:
        self._merge()
        if self._state is None:
            return np.empty(0, WINNER_DTYPE)
        key, d2, _seq, gidx, fidx = self._state
        out = np.empty(len(key), WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = gidx
        out["file_idx"] = fidx
        return out


def _merge_soa_py(a: tuple[np.ndarray, ...], b: tuple[np.ndarray, ...]):
    """numpy fallback for native.winner_merge: same winner rule via lexsort
    over the concatenation (both inputs are already per-key unique)."""
    key = np.concatenate([a[0], b[0]])
    d2 = np.concatenate([a[1], b[1]])
    seq = np.concatenate([a[2], b[2]])
    gidx = np.concatenate([a[3], b[3]])
    fidx = np.concatenate([a[4], b[4]])
    order = np.lexsort((gidx, seq, d2, key))
    key, d2, seq, gidx, fidx = (
        key[order], d2[order], seq[order], gidx[order], fidx[order])
    first = np.empty(len(key), bool)
    first[0] = True
    first[1:] = key[1:] != key[:-1]
    return key[first], d2[first], seq[first], gidx[first], fidx[first]


def merge_winners_host(state: np.ndarray | None, new: np.ndarray) -> np.ndarray:
    """Merge candidate rows (exact key/d²) into the sparse running state.

    Ties on d² keep the earlier-inserted point (rank: existing state first,
    then ascending gidx within the new batch), matching the reference's
    strict < replacement (grid_sampling.rs:97)."""
    if new is not None and len(new) == 0:
        new = None
    if state is None or len(state) == 0:
        merged = new
        n_old = 0
    elif new is None:
        return state
    else:
        merged = np.concatenate([state, new])
        n_old = len(state)
    if merged is None:
        return np.empty(0, WINNER_DTYPE)
    if len(merged) <= 1:
        return merged
    rank = np.zeros(len(merged), np.int8)
    rank[n_old:] = 1
    order = np.lexsort((merged["gidx"], rank, merged["d2"], merged["key"]))
    merged = merged[order]
    first = np.empty(len(merged), bool)
    first[0] = True
    first[1:] = merged["key"][1:] != merged["key"][:-1]
    return merged[first]


# ---------------------------------------------------------------------------
# device half: candidate selection, plain version and kernels
# ---------------------------------------------------------------------------

# the per-file arrays of GridSpec3D.file_tables, in the order of mesh.py's
# _DENSITY_TABLE_KEYS
TABLE_KEYS = (
    "bx", "by", "bz", "crx", "cfx", "cry", "cfy", "crz", "cfz",
    "q0i", "q0f", "dpl", "scale", "dims", "eps_abs",
)
# the kernels take each axis's cell count from the length of its centre
# table, so "dims" stays on the host's side of the launch
_KERNEL_TABLE_KEYS = tuple(k for k in TABLE_KEYS if k != "dims")


def tables_to_device(tables: dict, device) -> dict:
    """GridSpec3D.file_tables' numpy arrays -> tensors on device (the 0-d
    eps_abs as a (1,) tensor). They are per-file constants: upload once per
    file."""
    arrays = dict(tables, eps_abs=np.asarray(tables["eps_abs"], np.float32).reshape(1))
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device) for k in TABLE_KEYS}


def table_slots(n_points: int, cells: int | None = None) -> int:
    """Slots per block of the leaders table for a block with at most
    n_points predicate hits over a grid of `cells` cells (grid_cells): the
    power of two >= 2 * min(n_points, cells) (load factor <= 1/2), at least
    64. Without cells, by the hits alone."""
    n = int(n_points) if cells is None else min(int(n_points), int(cells))
    return max(64, 1 << (2 * max(n, 1) - 1).bit_length())


def slot_bytes(cells: int) -> int:
    """Bytes of one slot of the leaders table over a grid of `cells` cells,
    the one place the layout is chosen: below 2^32 cells one uint64 word,
    key << 32 | d2 bits (a key then never reaches 0xFFFFFFFF, so the
    all-ones word is "empty"); else 16 bytes, (uint64 key, uint32 d2 bits,
    pad). Either way a slot lies in one 32-byte sector."""
    return 8 if int(cells) < 1 << 32 else 16


def _table_dims(tables: dict) -> tuple[int, int, int]:
    return tuple(int(tables[f"cr{a}"].shape[0]) for a in "xyz")


def grid_cells(tables: dict) -> int:
    """The cell count of the grid of a file's tables (a degenerate axis
    counts one cell), from the tables' shapes: no device read."""
    dx, dy, dz = _table_dims(tables)
    return dx * dy * dz


def _table_slots_of(table, k_blocks: int, cells: int) -> int:
    """Slots per block of a leaders table of K blocks over a grid of `cells`
    cells; raises if its size fits no layout."""
    words = slot_bytes(cells) // 4
    slots, rest = divmod(table.numel(), max(k_blocks, 1) * words)
    if rest or slots < 1 or slots & (slots - 1):
        raise ValueError(
            f"a leaders table of {table.numel()} int32 words fits no layout for {k_blocks} "
            f"blocks of {slot_bytes(cells)}-byte slots (a power of two of them a block)")
    return slots


def table_leaders(table, k_blocks: int, cells: int) -> list:
    """A leaders table of density_leaders over a grid of `cells` cells ->
    per block (the occupied cells' keys ascending as unsigned 64-bit numbers,
    in int64; their d2 bit patterns, int32): density_leaders_plain's result
    with its values viewed as int32."""
    slots = _table_slots_of(table, k_blocks, cells)
    if slot_bytes(cells) == 8:
        halves = table.view(k_blocks, slots, 2)  # little-endian: d2 bits, then key
        keys = halves[:, :, 1].to(torch.int64) & 0xFFFFFFFF
        vals = halves[:, :, 0]
        used = halves[:, :, 1] != -1
    else:
        keys = table.view(torch.int64).view(k_blocks, slots, 2)[:, :, 0]
        vals = table.view(k_blocks, slots, 4)[:, :, 2]
        used = keys != -1
    out = []
    for k in range(k_blocks):
        key, val = keys[k][used[k]], vals[k][used[k]]
        order = torch.argsort(key ^ (-(1 << 63)))  # unsigned order
        out.append((key[order], val[order]))
    return out


def _wrap_i32(v64):
    """int64 values -> their int32 two's-complement wrap, still int64."""
    return ((v64 + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _axis_cells(p, b, cr, cf, q0i, q0f, dpl, scale, dim: int):
    """One axis of (n,) int32 coordinates -> (cell (n,) int64, certified
    (n,) bool, scaled f32 distance to the cell centre): the per-axis math of
    _density_candidates_1 (density.py:355-372), every f32 operation rounded
    on its own."""
    p64 = p.to(torch.int64)
    est = (_wrap_i32(p64 - q0i.to(torch.int64)).to(torch.float32) - q0f) * dpl
    # a defined float -> int conversion: NaN and everything outside
    # [-1, dim] is clamped first (the clip to [0, dim - 1] follows anyway)
    est = torch.nan_to_num(est, nan=-1.0).clamp(-1.0, float(dim))
    c = est.to(torch.int64).clamp(0, dim - 1)
    # +-2 correction against the exact boundaries (b has dim + 2 entries)
    for _ in range(2):
        c = torch.where(p >= b[torch.clamp(c + 1, max=dim)], c + 1, c)
    for _ in range(2):
        c = torch.where(p < b[c], c - 1, c)
    c = c.clamp(0, dim - 1)
    certified = (p >= b[c]) & (p < b[c + 1])
    certified &= p < b[dim]  # beyond the max face the reference's key wraps
    certified &= (p < int(I32_MAX)) & (p > int(I32_MIN))  # the tables are clamped there
    di = _wrap_i32(p64 - cr[c].to(torch.int64))
    certified &= (di > -(1 << 30)) & (di < (1 << 30))  # int32 subtraction overflow guard
    dloc = di.to(torch.float32) - cf[c]
    return c, certified, dloc * scale


def _block_cells(x, y, z, tables: dict):
    """One block's (n,) int32 x/y/z -> (cells (n, 3) int64, certified (n,)
    bool, d2 (n,) f32). A point is not certified either if its d2 is NaN or
    if its cell's linear key is the leaders table's empty key (all ones: the
    grid's last cell, and only when the grid has exactly 2^64 cells)."""
    dims = _table_dims(tables)
    cells, oks, ds = [], [], []
    for a, (p, name) in enumerate(zip((x, y, z), "xyz")):
        c, ok, d = _axis_cells(
            p, tables[f"b{name}"], tables[f"cr{name}"], tables[f"cf{name}"],
            tables["q0i"][a], tables["q0f"][a], tables["dpl"][a], tables["scale"][a], dims[a])
        cells.append(c)
        oks.append(ok)
        ds.append(d)
    d2 = (ds[0] * ds[0] + ds[1] * ds[1]) + ds[2] * ds[2]
    certified = oks[0] & oks[1] & oks[2] & ~torch.isnan(d2)
    if dims[0] * dims[1] * dims[2] == 1 << 64:
        certified &= ~((cells[0] == dims[0] - 1) & (cells[1] == dims[1] - 1)
                       & (cells[2] == dims[2] - 1))
    return torch.stack(cells, 1), certified, d2


def _cell_groups(cells, dims):
    """(n, 3) int64 cells -> (linear keys (n,) int64 or None, unique cells,
    inverse (n,)). The linear key (cz * dimy + cy) * dimx + cx is the
    kernels' table key; it is used when it fits int64."""
    if dims[0] * dims[1] * dims[2] < 1 << 63:
        keys = (cells[:, 2] * dims[1] + cells[:, 1]) * dims[0] + cells[:, 0]
        uniq, inv = torch.unique(keys, return_inverse=True)
        return keys, uniq, inv
    uniq, inv = torch.unique(cells, dim=0, return_inverse=True)
    return None, uniq, inv


def _leaders(d2, inv, n_groups: int):
    lead = torch.full((n_groups,), float("inf"), dtype=torch.float32, device=d2.device)
    return lead.scatter_reduce_(0, inv, d2, "amin", include_self=False)


def _valid_rows(mask_rows, nvs):
    return mask_rows & predicate._valid(nvs, mask_rows.shape[1], mask_rows.device)


def density_leaders_plain(xs, ys, zs, mask_rows, nvs, tables: dict) -> list:
    """The plain version of pass 1: for each of the K blocks, (linear cell
    keys ascending (int64), their least f32 d2) over the valid certified
    points. Needs a grid of fewer than 2^63 cells (the keys are int64)."""
    dims = _table_dims(tables)
    valid = _valid_rows(mask_rows, nvs)
    out = []
    for k in range(xs.shape[0]):
        rows = torch.nonzero(valid[k])[:, 0]
        cells, certified, d2 = _block_cells(xs[k][rows], ys[k][rows], zs[k][rows], tables)
        keys, uniq, inv = _cell_groups(cells[certified], dims)
        if keys is None:
            raise ValueError("density_leaders_plain needs a grid of fewer than 2^63 cells")
        out.append((uniq, _leaders(d2[certified], inv, len(uniq))))
    return out


def density_candidates_plain(xs, ys, zs, mask_rows, nvs, tables: dict):
    """(K, B) int32 x/y/z, (K, B) bool predicate mask, (K,) int32 n_valid and
    the file's tables -> (K, B) bool candidates: among the valid certified
    points of a block, those with d2 <= (leader + EPS_REL * leader) +
    eps_abs of their cell's leader (its least d2), and every valid
    uncertified point (_density_candidates_1, density.py:339-411, without
    its sort and cap)."""
    dims = _table_dims(tables)
    valid = _valid_rows(mask_rows, nvs)
    cand = torch.zeros_like(valid)
    for k in range(xs.shape[0]):
        rows = torch.nonzero(valid[k])[:, 0]
        cells, certified, d2 = _block_cells(xs[k][rows], ys[k][rows], zs[k][rows], tables)
        _, uniq, inv = _cell_groups(cells[certified], dims)
        d2c = d2[certified]
        lead = _leaders(d2c, inv, len(uniq))[inv]
        near = d2c <= (lead + EPS_REL * lead) + tables["eps_abs"][0]
        keep = ~certified
        keep[certified] = near
        cand[k, rows[keep]] = True
    return cand


def unpack_xyz(planes, bases, widths, block_size: int) -> list:
    """Packed-transport x/y/z -> absolute (K, B) int32: the k-bit residual
    planes unpacked, plus the block's base (mesh.py:376-378). The add wraps
    in int32 as the kernel's unsigned add does."""
    out = []
    for a in range(3):
        r = predicate.unpack_bits(planes[a], int(widths[a]), block_size).to(torch.int64)
        out.append(_wrap_i32(r + bases[:, a : a + 1].to(torch.int64)).to(torch.int32))
    return out


def _check_tables(tables: dict, device) -> tuple:
    dims = _table_dims(tables)
    for a, name in enumerate("xyz"):
        if dims[a] < 1:
            raise ValueError(f"cr{name} is empty: every axis has at least one cell")
        _check(tables[f"b{name}"], f"b{name}", torch.int32, (dims[a] + 2,), device)
        _check(tables[f"cr{name}"], f"cr{name}", torch.int32, (dims[a],), device)
        _check(tables[f"cf{name}"], f"cf{name}", torch.float32, (dims[a],), device)
    _check(tables["q0i"], "q0i", torch.int32, (3,), device)
    for name in ("q0f", "dpl", "scale"):
        _check(tables[name], name, torch.float32, (3,), device)
    _check(tables["eps_abs"], "eps_abs", torch.float32, (1,), device)
    return dims


def _operands(xyz, mask_bits, nvs, tables, block_size, bases, widths):
    """Check one density launch's operands; returns (entry suffix, point
    tensors, kernel tables, sizes after (K, B, slots))."""
    k_blocks = xyz[0].shape[0]
    dev = xyz[0].device
    if not _on_cuda(xyz[0]):
        raise ValueError("the density kernels take CUDA tensors; CPU tensors go through "
                         "density_candidates_bits to the plain version")
    dims = _check_tables(tables, dev)
    _check(mask_bits, "mask bits", torch.int32, (k_blocks, mask_words(block_size)), dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    tabs = tuple(tables[k] for k in _KERNEL_TABLE_KEYS)
    if widths is None:
        for name, t in zip("xyz", xyz):
            _check(t, f"{name}s", torch.int32, (k_blocks, block_size), dev)
        return "", tuple(xyz), tabs, dims
    widths = tuple(int(w) for w in widths)
    for name, t, w in zip("xyz", xyz, widths):
        _check_planes(t, f"{name}p", w, 32, k_blocks, block_size, dev)
    _check(bases, "bases", torch.int32, (k_blocks, 3), dev)
    return "_packed", (*xyz, bases), tabs, (*dims, *widths)


def density_leaders(xyz, mask_bits, nvs, tables: dict, block_size: int, *, bases=None,
                    widths=None, slots: int | None = None):
    """Pass 1 on CUDA tensors: xyz as in density_candidates_bits, the
    predicate's mask words -> the leaders table, an int32 tensor of K
    regions of `slots` slots (a power of two; default: for a full block,
    table_slots(block_size, grid_cells(tables))) in the layout slot_bytes
    picks for the grid (table_leaders decodes it). A block with more
    occupied cells than slots loses nothing: pass 2 keeps every point whose
    cell it does not find. The entry clears the table before the kernel
    fills it."""
    k_blocks = xyz[0].shape[0]
    cells = grid_cells(tables)
    slots = table_slots(block_size, cells) if slots is None else int(slots)
    if slots < 1 or slots & (slots - 1):
        raise ValueError(f"slots must be a power of two, got {slots}")
    suffix, points, tabs, sizes = _operands(xyz, mask_bits, nvs, tables, block_size, bases, widths)
    nbytes = slot_bytes(cells)
    table = torch.empty(k_blocks * slots * nbytes // 4, dtype=torch.int32, device=xyz[0].device)
    predicate.run(f"density_leaders{suffix}", (*points, mask_bits, nvs, *tabs, table),
                  (k_blocks, block_size, slots, nbytes, *sizes))
    return table


def density_candidates(xyz, mask_bits, nvs, tables: dict, table, block_size: int, *,
                       bases=None, widths=None) -> BitMask:
    """Pass 2 on CUDA tensors: the operands of density_leaders and its
    table -> the candidates' BitMask."""
    k_blocks = xyz[0].shape[0]
    cells = grid_cells(tables)
    slots = _table_slots_of(table, k_blocks, cells)
    nbytes = slot_bytes(cells)
    _check(table, "table", torch.int32, (k_blocks * slots * nbytes // 4,), xyz[0].device)
    suffix, points, tabs, sizes = _operands(xyz, mask_bits, nvs, tables, block_size, bases, widths)
    return predicate._launch_mask(f"density_candidates{suffix}",
                                  (*points, mask_bits, nvs, *tabs, table),
                                  (k_blocks, block_size, slots, nbytes, *sizes))


def density_candidates_bits(xyz, mask: BitMask, nvs, tables: dict, block_size: int, *,
                            bases=None, widths=None, slots: int | None = None) -> BitMask:
    """The density step after its predicate: the candidates among the
    points of mask, as a BitMask of the same K blocks of B rows.

    xyz: three (K, B) int32 coordinate rows, or (widths given) three (K, row
    width) u8 plane stacks of k-bit residuals with bases (K, 3) int32, which
    are rebuilt to absolute int32. mask: the step's predicate. nvs: (K,)
    int32. tables: tables_to_device(GridSpec3D.file_tables(...)) of the
    file, of a grid GridSpec3D.create accepted (at most 2^64 cells). slots:
    table slots per block, a power of two of at least twice the cells the
    largest block can hold, the fewer of its predicate hits and the grid's
    cells (table_slots(hits, grid_cells(tables))); default: for a full
    block.

    CPU tensors take the plain version; CUDA tensors launch the two kernels
    of csrc/density.cu or raise. Replaces density_candidates_multi
    (density.py:430-451) and block_density_candidates (:418-427)."""
    if not _on_cuda(xyz[0]):
        rows = predicate.unpack_mask_bits(mask.bits, block_size)
        if widths is not None:
            xyz = unpack_xyz(xyz, bases, widths, block_size)
        return predicate.pack_mask_bits(density_candidates_plain(*xyz, rows, nvs, tables))
    table = density_leaders(xyz, mask.bits, nvs, tables, block_size, bases=bases,
                            widths=widths, slots=slots)
    return density_candidates(xyz, mask.bits, nvs, tables, table, block_size, bases=bases,
                              widths=widths)

"""Host helpers of the count path, copied from jax-importing modules.

Each function is a copy of its original in the JAX package, kept identical
in behaviour and pinned by tests/test_torch_host.py on random inputs:

  encode_f64_sortable,             ops/predicate.py:195-224
  encode_f64_scalar
  bits_width, residual_u32,        ops/predicate.py:407-425
  pack_bits_into                   ops/predicate.py:428-473
  packed_row_width                 ops/predicate.py:476-477
  class_dict_encode,               ops/predicate.py:562-594
  class_dict_width
  pack_class_words                 ops/predicate.py:629-634
  _assembly_pool, _stack_rows,     engine.py:122-176
  _stack_planes
  _pack_range_tasks                engine.py:235-266
  _pack_transport_enabled          engine.py:302-304
  _residual_width                  engine.py:307-327
  _packed_xyz_cols                 engine.py:330-345
  _packed_time_cols,               engine.py:348-371
  _packed_time_query
  _packed_class_cols               engine.py:374-392

The nibble-rounded widths and their <= 28-bit cap stay: on CUDA the widths
are runtime kernel arguments, so the compile-count reason for the rounding
is gone, but the exactness of the saturating residual-space clips (bbox
bounds in engine._run_count, time queries in _packed_time_query) rests on
the cap.
"""

from __future__ import annotations

import os

import numpy as np

from .shared import native


def encode_f64_sortable(t) -> tuple:
    """f64 array -> (hi, lo) int32 arrays, order-preserving.

    enc(a) < enc(b) lexicographically (signed int32) iff a < b as doubles
    (total order; NaNs sort by payload). -0.0 is normalized to +0.0 first
    (`t + 0.0`) so encoded compares agree with IEEE f64 compares at that
    edge (f64 has -0.0 == 0.0; the raw bit order would put -0.0 < +0.0).
    """
    arr = np.asarray(t, np.float64) + 0.0  # -0.0 -> +0.0
    bits = np.ascontiguousarray(arr).view(np.uint64)
    neg = (bits >> np.uint64(63)).astype(bool)
    flipped = np.where(neg, ~bits, bits ^ np.uint64(1 << 63))
    hi = ((flipped >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)).view(
        np.int32
    )
    lo = ((flipped & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ np.uint32(0x80000000)).view(
        np.int32
    )
    return hi, lo


def encode_f64_scalar(v: float) -> tuple[int, int]:
    hi, lo = encode_f64_sortable(np.asarray([v], np.float64))
    return int(hi[0]), int(lo[0])


def bits_width(rng_i64) -> int:
    """Residual bits needed for a non-negative int range (max - min)."""
    return max(int(rng_i64).bit_length(), 0)


def residual_u32(col_i32, k: int, base: int):
    """int32 column -> u32 residual stream for a k-bit packing.

    k == 32 with base == 0 ships the raw two's-complement words; k == 32
    with base != 0 arises when a NARROW block is stacked into a 32-bit-wide
    step (the engine forces base=0 whenever a block's own range needs 32
    bits, so these residuals always stay < 2^31 and the device's signed
    int32 compare remains exact). Mirrors the native packer's mod-2^32
    arithmetic (aqpc_native.cpp aqpc_pack_bits)."""
    if k >= 32 and base == 0:
        return np.ascontiguousarray(col_i32, np.int32).view(np.uint32)
    return (col_i32.astype(np.int64) - base).astype(np.uint32)


def pack_bits_into(out_row, col_i32, k: int, base: int, block_size: int) -> None:
    """Write the k-bit planes of (col - base) into one stacked row.

    out_row: (nbytes*B + nbits*(B//8),) u8 slice of the step operand; col
    may be shorter than B (ragged tail: trailing plane bytes are left
    unwritten — every kernel masks by n_valid). Uses the single-pass native
    packer when available (the numpy path is ~k/4 strided passes). A u8
    col (dictionary codes, base 0, k <= 8) stays u8 through the native
    packer — no int32 widening pass on the host."""
    if (
        getattr(col_i32, "dtype", None) == np.uint8
        and base == 0
        and 1 <= k <= 8
        and out_row.flags.c_contiguous
    ):
        col8 = np.ascontiguousarray(col_i32, np.uint8)
        if native.pack_bits_u8(col8, k, out_row, block_size):
            return
    col = np.ascontiguousarray(col_i32, np.int32)
    if out_row.flags.c_contiguous and native.pack_bits(
        col, base, k, out_row, block_size
    ):
        return
    r_u32 = residual_u32(col, k, base)
    nbytes, nbits = k // 8, k % 8
    n = r_u32.shape[0]
    for p in range(nbytes):
        out_row[p * block_size : p * block_size + n] = (
            r_u32 >> np.uint32(8 * p)
        ).astype(np.uint8)
    if nbits:
        off = nbytes * block_size
        bb = block_size // 8
        nb = (n + 7) // 8
        for q in range(nbits):
            out_row[off + q * bb : off + q * bb + nb] = np.packbits(
                ((r_u32 >> np.uint32(8 * nbytes + q)) & np.uint32(1)).astype(
                    np.uint8
                ),
                bitorder="little",
            )


def packed_row_width(k: int, block_size: int) -> int:
    return (k // 8) * block_size + (k % 8) * (block_size // 8)


def class_dict_encode(cls_u8):
    """One block's u8 class column -> (present values sorted u8, codes u8).

    codes[i] = index of cls_u8[i] in present (dense, 0-based). Native path:
    one C pass (presence table + LUT gather); numpy fallback: bincount +
    256-entry LUT gather."""
    col = np.ascontiguousarray(cls_u8, np.uint8)
    encoded = native.dict_encode_u8(col)
    if encoded is not None:
        return encoded
    counts = np.bincount(col, minlength=256)
    present = np.flatnonzero(counts).astype(np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[present] = np.arange(len(present), dtype=np.uint8)
    return present, lut[col]


def class_dict_width(n_present: int, block_size: int) -> int:
    """Plane bits for a dictionary of n_present entries: pow2-rounded,
    byte-rounded when bit planes can't be laid out."""
    k = bits_width(max(n_present - 1, 0))
    if block_size % 8:
        return 8  # bit planes need B % 8 == 0; byte planes only
    p = 1
    while p < k:
        p *= 2
    return p  # 1..8 (a single-class block still ships its 1-bit zeros)


def pack_class_words(cls_u8):
    """Host-side zero-copy view: (.., B) u8 -> (.., B//4) int32 words (LE)."""
    assert cls_u8.dtype == np.uint8 and cls_u8.shape[-1] % 4 == 0
    return cls_u8.view(np.int32)


_ASSEMBLY_POOL = None


def _assembly_pool():
    """Small shared pool for step-operand assembly: the row copies release
    the GIL, so multicore hosts overlap them (the copy would otherwise run
    serially on the main thread between device dispatches)."""
    global _ASSEMBLY_POOL
    if _ASSEMBLY_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _ASSEMBLY_POOL = ThreadPoolExecutor(max_workers=4)
    return _ASSEMBLY_POOL


def _stack_rows(batch, key: str, rows: int, block_size: int, dtype) -> np.ndarray:
    """Assemble one step operand: each task's unpadded column copied once
    into its row (pad + stack fused; padding content is never read — every
    kernel masks by per-block n_valid)."""
    out = np.empty((rows, block_size), dtype)

    def fill(j):
        col = batch[j].columns[key]
        out[j, : len(col)] = col

    if len(batch) >= 4 and block_size >= 1 << 16:
        list(_assembly_pool().map(fill, range(len(batch))))
    else:
        for j in range(len(batch)):
            fill(j)
    return out


def _stack_planes(batch, key: str, axis: int, rows: int, k_bits: int,
                  block_size: int) -> np.ndarray:
    """Assemble one packed-transport operand: (rows, k//8*B + k%8*(B//8))
    u8 bit/byte planes of each block's u32 residual stream. Every plane is
    extracted from the full residual, so blocks narrower than the step
    width contribute all-zero high planes naturally; pad tails are masked
    by n_valid like every other kernel."""
    out = np.empty((rows, packed_row_width(k_bits, block_size)), np.uint8)

    def fill(j):
        base = int(batch[j].columns["base"][axis])
        pack_bits_into(out[j], batch[j].columns[key], k_bits, base, block_size)

    if len(batch) >= 4 and block_size >= 1 << 16:
        list(_assembly_pool().map(fill, range(len(batch))))
    else:
        for j in range(len(batch)):
            fill(j)
    return out


def _pack_range_tasks(file_idx: int, ranges, block_size: int) -> list:
    """Disjoint ascending [s, e) ranges -> BlockFeeder multi-range tasks,
    each packing up to block_size points (oversized ranges split). Groups
    of 1 full contiguous block degrade to ordinary 4-tuple tasks."""
    tasks: list = []
    group: list[tuple[int, int]] = []
    total = 0

    def flush():
        nonlocal group, total
        if not group:
            return
        if len(group) == 1:
            s, e = group[0]
            tasks.append((file_idx, s // block_size, s, e))
        else:
            tasks.append((file_idx, group[0][0] // block_size, tuple(group)))
        group, total = [], 0

    for s, e in ranges:
        while s < e:
            take = min(e - s, block_size - total)
            if group and group[-1][1] == s:  # adjacent after a split
                group[-1] = (group[-1][0], s + take)
            else:
                group.append((s, s + take))
            total += take
            s += take
            if total == block_size:
                flush()
    flush()
    return tasks


def _pack_transport_enabled() -> bool:
    """Byte-planar packed coordinate H2D transport (AQPC_PACK, default on)."""
    return os.environ.get("AQPC_PACK", "1") != "0"


def _residual_width(col: np.ndarray, block_size: int) -> tuple[int, int]:
    """(k_bits, base) for packing one int32 column as k-bit residuals.

    Nibble-rounded widths (multiples of 4, not exact k), capped at 28 bits
    below 32: the cap is what makes the saturating i64->i32 clip of
    residual-space bounds exact (residuals < 2^28 never collide with a
    saturated bound); k == 32 forces base = 0, so bounds pass through
    unclipped. Byte planes only when bit planes can't be laid out
    (block_size % 8 != 0)."""
    mn = int(col.min())
    k = (bits_width(int(col.max()) - mn) + 3) // 4 * 4
    if k >= 32 or block_size % 8:
        k = min((k + 7) // 8 * 8, 32)
    if k >= 32:
        return 32, 0
    return k, mn


def _packed_xyz_cols(pos: np.ndarray, block_size: int) -> dict:
    """Packed-transport columns for one block's (N, 3) int32 positions.
    Residualization happens at plane-extraction (stack) time; this just
    records each axis's raw column + (base, width)."""
    cols = {}
    base = np.zeros(3, np.int64)
    w = np.empty(3, np.int64)
    for a, key in enumerate(("xp", "yp", "zp")):
        col = np.ascontiguousarray(pos[:, a])
        k, mn = _residual_width(col, block_size)
        cols[key] = col
        base[a] = mn
        w[a] = k
    cols["base"] = base
    cols["w"] = w
    return cols


def _packed_time_cols(th: np.ndarray, tl: np.ndarray, block_size: int) -> dict:
    """Packed-transport columns for one block's encoded GPS times: the
    (hi, lo) int32 pair rides the same bit-planar packer as xyz."""
    kh, bh = _residual_width(th, block_size)
    kl, bl = _residual_width(tl, block_size)
    return {
        "thp": th,
        "tlp": tl,
        "base": np.asarray([bh, bl], np.int64),
        "w": np.asarray([kh, kl], np.int64),
    }


def _packed_time_query(q_enc, base) -> np.ndarray:
    """Residual-space encoded range for one block: (q0h, q0l, q1h, q1l)
    shifted by the block's (hi, lo) bases, saturating-clipped to int32
    (exact under the <= 28-bit width cap — see _residual_width)."""
    i32 = np.iinfo(np.int32)
    shift = np.asarray([base[0], base[1], base[0], base[1]], np.int64)
    return np.clip(
        np.asarray(q_enc, np.int64) - shift, i32.min, i32.max
    ).astype(np.int32)


def _packed_class_cols(cls: np.ndarray, target: int, block_size: int) -> dict:
    """Dictionary-coded transport columns for one block's u8 class column.

    codes are u8 dictionary indices (class_dict_encode); "t" carries the
    target's code, or len(dict) — a code no point has — when the target
    class is absent; "np" the dictionary size so the count path can resolve
    absent/single-class blocks host-side with no device work."""
    present, codes = class_dict_encode(cls)
    pos = int(np.searchsorted(present, np.uint8(target)))
    tcode = pos if pos < len(present) and int(present[pos]) == int(target) else len(present)
    return {
        "clsp": codes,  # u8 end-to-end: pack_bits_into has a native u8 path
        "base": np.zeros(1, np.int64),
        "w": np.asarray([class_dict_width(len(present), block_size)], np.int64),
        "t": np.asarray([tcode], np.int64),
        "np": np.asarray([len(present)], np.int64),
    }

"""ctypes bindings for the native host codecs (aqpc_native.cpp).

Builds the shared library on first import with g++ (no pybind11 in this
image — plain C ABI + ctypes, which also releases the GIL during calls so a
Python thread pool gets real multicore decode).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SOURCES = [_HERE / "aqpc_native.cpp", _HERE / "laszip.cpp"]
_LOCK = threading.Lock()
_LIB = None


def _build_if_needed() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    so_path = _HERE / f"_aqpc_native_{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    # Build under a name of this process's own and rename: a concurrent
    # process sees the whole library or none. Builds of other source hashes
    # stay, because another process may be loading one.
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        # g++ contracts a*b+c into fma even in ISO mode; the density exact
        # -resolution functions must round f64 ops exactly like numpy's (and
        # the reference Rust's) separate mul/add or winner ties change
        "-ffp-contract=off",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-pthread",
        "-o",
        str(tmp),
    ] + [str(s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)
    return so_path


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if os.environ.get("AQPC_DISABLE_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(_build_if_needed()))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.aqpc_xxh32.restype = ctypes.c_uint32
        lib.aqpc_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.aqpc_lz4_block_decompress.restype = ctypes.c_int64
        lib.aqpc_lz4_block_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.aqpc_lz4_block_compress.restype = ctypes.c_int64
        lib.aqpc_lz4_block_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.aqpc_lz4_compress_bound.restype = ctypes.c_size_t
        lib.aqpc_lz4_compress_bound.argtypes = [ctypes.c_size_t]
        lib.aqpc_lz4_frame_decompress.restype = ctypes.c_int64
        lib.aqpc_lz4_frame_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.aqpc_lz4_frame_compress.restype = ctypes.c_int64
        lib.aqpc_lz4_frame_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.aqpc_lz4_frames_decompress.restype = ctypes.c_int64
        lib.aqpc_lz4_frames_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.aqpc_laz_read_chunk_table.restype = ctypes.c_int64
        lib.aqpc_laz_read_chunk_table.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int64]
        lib.aqpc_laz_write_chunk_table.restype = ctypes.c_int64
        lib.aqpc_laz_write_chunk_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t]
        lib.aqpc_laz_read_chunk_table_var.restype = ctypes.c_int64
        lib.aqpc_laz_read_chunk_table_var.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.aqpc_laz_write_chunk_table_var.restype = ctypes.c_int64
        lib.aqpc_laz_write_chunk_table_var.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_size_t]
        lib.aqpc_laz_decode_chunks.restype = ctypes.c_int64
        lib.aqpc_laz_decode_chunks.argtypes = (
            [ctypes.c_void_p, ctypes.c_size_t]  # file, size
            + [ctypes.c_void_p] * 4             # offsets, sizes, counts, out offsets
            + [ctypes.c_int64]                  # n_chunks
            + [ctypes.c_void_p] * 13            # x..wave, extra
            + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
               ctypes.c_int64]                  # extra_size, gps, rgb, wave, threads
        )
        lib.aqpc_laz_encode_chunks.restype = ctypes.c_int64
        lib.aqpc_laz_encode_chunks.argtypes = (
            [ctypes.c_void_p] * 13              # x..wave, extra
            + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
               ctypes.c_int64, ctypes.c_int64]  # extra, gps, rgb, wave, n, chunk
            + [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int64]
        )
        lib.aqpc_laz14_decode_chunks.restype = ctypes.c_int64
        lib.aqpc_laz14_decode_chunks.argtypes = (
            [ctypes.c_void_p, ctypes.c_size_t]  # file, size
            + [ctypes.c_void_p] * 4             # offsets, sizes, counts, out offsets
            + [ctypes.c_int64]                  # n_chunks
            + [ctypes.c_void_p] * 15            # x..nir, wave, extra
            + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
               ctypes.c_int64]                  # extra, rgb, nir, wave, threads
        )
        lib.aqpc_laz14_encode_chunks.restype = ctypes.c_int64
        lib.aqpc_laz14_encode_chunks.argtypes = (
            [ctypes.c_void_p] * 15              # x..nir, wave, extra
            + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
               ctypes.c_int64, ctypes.c_int64]  # extra, rgb, nir, wave, n, chunk
            + [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int64]
        )
        lib.aqpc_format_points.restype = ctypes.c_int64
        lib.aqpc_format_points.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.aqpc_pack_bits.restype = None
        lib.aqpc_pack_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64]
        lib.aqpc_dict_encode_u8.restype = ctypes.c_int32
        lib.aqpc_dict_encode_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.aqpc_pack_bits_u8.restype = None
        lib.aqpc_pack_bits_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64]
        lib.aqpc_density_exact.restype = None
        lib.aqpc_density_exact.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 3     # n, xi, yi, zi
            + [ctypes.c_void_p] * 5                      # scale..dimsf
            + [ctypes.c_double, ctypes.c_void_p]         # cell_size, masks
            + [ctypes.c_int32, ctypes.c_int32]           # xbits, xybits
            + [ctypes.c_void_p] * 2                      # out key, d2
        )
        lib.aqpc_winner_dedupe.restype = ctypes.c_int64
        lib.aqpc_winner_dedupe.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 6
        )
        lib.aqpc_winner_merge.restype = ctypes.c_int64
        lib.aqpc_winner_merge.argtypes = (
            [ctypes.c_int64] + [ctypes.c_void_p] * 5
            + [ctypes.c_int64] + [ctypes.c_void_p] * 5
            + [ctypes.c_void_p] * 5
        )
        _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


def lz4_frame_compress(data: bytes | np.ndarray) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8).ravel()
    cap = int(lib.aqpc_lz4_compress_bound(src.nbytes)) + 64
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.aqpc_lz4_frame_compress(
        src.ctypes.data_as(ctypes.c_void_p), src.nbytes,
        dst.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise RuntimeError("lz4 frame compression failed")
    return dst[:n].tobytes()


def lz4_frame_decompress(data: bytes | memoryview | np.ndarray, dst_cap: int) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = np.frombuffer(memoryview(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    dst = np.empty(dst_cap, dtype=np.uint8)
    consumed = ctypes.c_size_t(0)
    n = lib.aqpc_lz4_frame_decompress(
        src.ctypes.data_as(ctypes.c_void_p), src.nbytes,
        dst.ctypes.data_as(ctypes.c_void_p), dst_cap, ctypes.byref(consumed))
    if n < 0:
        raise RuntimeError(f"lz4 frame decompression failed (code {n})")
    return dst[:n]


def format_points(
    pos_world: np.ndarray, rgb: np.ndarray, cls: np.ndarray, intensity: np.ndarray
) -> str | None:
    """Batch-format --print-points lines in C (snprintf %.3f is correctly
    rounded, byte-identical to Python's f'{v:.3f}'). None if the native
    library is unavailable (caller falls back to Python formatting)."""
    lib = load()
    if lib is None:
        return None
    n = len(cls)
    p = np.ascontiguousarray(pos_world, np.float64).reshape(n, 3)
    c = np.ascontiguousarray(rgb, np.uint16).reshape(n, 3)
    k = np.ascontiguousarray(cls, np.uint8)
    it = np.ascontiguousarray(intensity, np.uint16)
    cap = 96 * n + 4096  # typical line ~70 B; retry covers the rest
    while True:
        out = np.empty(cap, np.uint8)
        need = lib.aqpc_format_points(
            p.ctypes.data_as(ctypes.c_void_p), c.ctypes.data_as(ctypes.c_void_p),
            k.ctypes.data_as(ctypes.c_void_p), it.ctypes.data_as(ctypes.c_void_p),
            n, out.ctypes.data_as(ctypes.c_void_p), cap)
        if need < 0:
            return None
        if need <= cap:
            return out[:need].tobytes().decode("ascii")
        cap = int(need)


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = load()
    if lib is None:
        from ..formats.lz4py import xxh32 as py_xxh32

        return py_xxh32(data, seed)
    return int(lib.aqpc_xxh32(data, len(data), seed))


def pack_bits(col_i32: np.ndarray, base: int, k: int, out_row: np.ndarray,
              block_size: int) -> bool:
    """Single-pass native bit-plane packer (ops/predicate.py layout).
    Returns False if the native library is unavailable."""
    lib = load()
    if lib is None:
        return False
    assert col_i32.dtype == np.int32 and col_i32.flags.c_contiguous
    assert out_row.dtype == np.uint8
    lib.aqpc_pack_bits(
        col_i32.ctypes.data_as(ctypes.c_void_p), len(col_i32), base, k,
        out_row.ctypes.data_as(ctypes.c_void_p), block_size)
    return True


def dict_encode_u8(cls_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Single native pass over a u8 class column -> (present sorted u8,
    codes u8), matching ops/predicate.class_dict_encode. None when the
    native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    assert cls_u8.dtype == np.uint8 and cls_u8.flags.c_contiguous
    codes = np.empty(len(cls_u8), np.uint8)
    present = np.empty(256, np.uint8)
    n_present = lib.aqpc_dict_encode_u8(
        cls_u8.ctypes.data_as(ctypes.c_void_p), len(cls_u8),
        codes.ctypes.data_as(ctypes.c_void_p),
        present.ctypes.data_as(ctypes.c_void_p))
    return present[:n_present].copy(), codes


def _vp(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def density_exact(
    xi: np.ndarray, yi: np.ndarray, zi: np.ndarray,
    scale: np.ndarray, offset: np.ndarray, bmin: np.ndarray, ext: np.ndarray,
    dims_f: np.ndarray, cell_size: float, masks: np.ndarray,
    xbits: int, xybits: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused exact reference cell key + f64 d² from raw int32 coords
    (one native pass; ops/density.GridSpec3D.exact_keys_d2 semantics).
    None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(xi)
    key = np.empty(n, np.uint64)
    d2 = np.empty(n, np.float64)
    lib.aqpc_density_exact(
        n, _vp(xi), _vp(yi), _vp(zi),
        _vp(scale), _vp(offset), _vp(bmin), _vp(ext), _vp(dims_f),
        float(cell_size), _vp(masks), int(xbits), int(xybits),
        _vp(key), _vp(d2))
    return key, d2


def winner_dedupe(
    order: np.ndarray, key: np.ndarray, d2: np.ndarray,
    seq: np.ndarray, gidx: np.ndarray,
) -> np.ndarray | None:
    """Per-key winner ORIGINAL indices over rows visited in `order`
    (ascending-key permutation). None when native is unavailable."""
    lib = load()
    if lib is None:
        return None
    out = np.empty(len(order), np.int64)
    m = lib.aqpc_winner_dedupe(
        len(order), _vp(order), _vp(key), _vp(d2), _vp(seq), _vp(gidx),
        _vp(out))
    return out[:m]


def winner_merge(
    a: tuple[np.ndarray, ...], b: tuple[np.ndarray, ...],
) -> tuple[np.ndarray, ...] | None:
    """Linear merge of two unique-key-ascending winner SoA sets
    (key, d2, seq, gidx, file_idx). None when native is unavailable."""
    lib = load()
    if lib is None:
        return None
    na, nb = len(a[0]), len(b[0])
    ko = np.empty(na + nb, np.uint64)
    d2o = np.empty(na + nb, np.float64)
    so = np.empty(na + nb, np.int32)
    go = np.empty(na + nb, np.int64)
    fo = np.empty(na + nb, np.int32)
    m = lib.aqpc_winner_merge(
        na, _vp(a[0]), _vp(a[1]), _vp(a[2]), _vp(a[3]), _vp(a[4]),
        nb, _vp(b[0]), _vp(b[1]), _vp(b[2]), _vp(b[3]), _vp(b[4]),
        _vp(ko), _vp(d2o), _vp(so), _vp(go), _vp(fo))
    return ko[:m], d2o[:m], so[:m], go[:m], fo[:m]


def pack_bits_u8(col_u8: np.ndarray, k: int, out_row: np.ndarray,
                 block_size: int) -> bool:
    """Native u8-input bit-plane packer (dictionary codes; base 0, k <= 8).
    Returns False if the native library is unavailable."""
    lib = load()
    if lib is None:
        return False
    assert col_u8.dtype == np.uint8 and col_u8.flags.c_contiguous
    assert out_row.dtype == np.uint8 and 1 <= k <= 8
    lib.aqpc_pack_bits_u8(
        col_u8.ctypes.data_as(ctypes.c_void_p), len(col_u8), k,
        out_row.ctypes.data_as(ctypes.c_void_p), block_size)
    return True

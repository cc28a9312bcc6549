"""Builds the CUDA kernels of csrc/ at first use and loads them with ctypes.

nvcc compiles every csrc/*.cu for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, cached as _build/<source hash>/libaqpc_cuda.so next to
this file; a source edit gives a new hash and so a new build. ptxas reports
each kernel's registers, shared memory and spills (-Xptxas -v); the
reports of every source are kept beside the library as nvcc.log
(build_log()). The library
is loaded with ctypes: every pointer and the CUDA stream is a c_void_p,
every size a c_int64, and each entry point returns cudaGetLastError().
Nothing here is imported or run until a kernel is launched on a CUDA tensor,
and a failed build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_CSRC = _HERE / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P = ctypes.c_void_p
_I = ctypes.c_int64
# entry point -> argument types (all return an int cudaError_t)
_ENTRY_POINTS = {
    "aqpc_bbox_count_multi": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "aqpc_bbox_count_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "aqpc_class_count_multi": [_P, _P, _P, _P, _P, _I, _I, _P],
    "aqpc_class_count_words": [_P, _P, _P, _P, _P, _I, _I, _P],
    "aqpc_class_count_dict": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "aqpc_time_count_multi": [_P, _P, _P, _P, _P, _I, _I, _P],
    "aqpc_time_count_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "aqpc_mask_bbox": [_P] * 8 + [_I, _I, _P],
    "aqpc_mask_bbox_packed": [_P] * 8 + [_I] * 5 + [_P],
    "aqpc_mask_class": [_P] * 6 + [_I, _I, _P],
    "aqpc_mask_class_dict": [_P] * 6 + [_I] * 3 + [_P],
    "aqpc_mask_time": [_P] * 7 + [_I, _I, _P],
    "aqpc_mask_time_packed": [_P] * 7 + [_I] * 4 + [_P],
    "aqpc_compact_bits": [_P] * 4 + [_I, _I, _P],
    "aqpc_compact_bits_gather": [_P] * 10 + [_I, _I, _P],
    "aqpc_density_leaders": [_P] * 20 + [_I] * 7 + [_P],
    "aqpc_density_leaders_packed": [_P] * 21 + [_I] * 10 + [_P],
    "aqpc_density_candidates": [_P] * 23 + [_I] * 7 + [_P],
    "aqpc_density_candidates_packed": [_P] * 24 + [_I] * 10 + [_P],
    "aqpc_bbox_probe_acc": [_P] * 8 + [_I, _I, _P],
    "aqpc_bbox_probe_acc_nomask": [_P] * 7 + [_I, _I, _P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _HERE / "_build" / h.hexdigest()[:16] / "libaqpc_cuda.so"


def build_log_path(so: Path | None = None) -> Path:
    """nvcc's output of every source of the library so (default: the
    current sources' library), ptxas's reports among it."""
    return (so or library_path()).with_name("nvcc.log")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build the kernels")
    return str(nvcc)


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        if src.suffix == ".cu":
            obj = so.with_name(f"{src.stem}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, obj, proc))
    failed, logs = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"{' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed with " + "\n".join(failed))
        tmp = so.with_name(f"{so.name}.{tag}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log = so.with_name(f"nvcc.log.{tag}")
        log.write_text("\n".join(logs))
        os.replace(log, build_log_path(so))
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.aqpc_error_string.argtypes = [ctypes.c_int]
            lib.aqpc_error_string.restype = ctypes.c_char_p
            lib.aqpc_mask_chunk_words.argtypes = []
            lib.aqpc_mask_chunk_words.restype = _I
            from .ops.predicate import CHUNK_WORDS

            if lib.aqpc_mask_chunk_words() != CHUNK_WORDS:
                raise RuntimeError("csrc/collect.cuh kChunkWords differs from CHUNK_WORDS")
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().aqpc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 (Hopper,
sm_90a), with nvcc on CUDA_HOME:

    python3 chip_smoke.py

Phases, in order; the first fault raises and the script exits non-zero:

  1. environment: card name and power limit (nvidia-smi), torch, CUDA and
     nvcc versions; no CUDA device is an error
  2. build: nvcc builds the kernels of adhoc_queries_pointclouds_torch/csrc
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (K=4 blocks of 2^21 points; the probe's 2^24
     points), exact equality; kernel and plain times (CUDA events, median of
     25 runs, L2 flushed before each) and the bytes moved per second. The
     collect kernels (one bit-mask entry per collect kind, and the ordered
     compaction of the partial blocks' hits) run at hit densities 0, 0.1 %,
     1/2 and 1, n_valid 0, 1, B-1 and B, every packed width, and an
     unaligned block size
  4. end to end, through the port's CLI over generated point-format-3 LAS
     and LAST datasets (8 files x 8M points) and LAZER and LAZ ones
     (2 x 2M), five paths, each with the launch counters set to 0 just
     before it and read just after:
       bbox: counts in both transports with the sidecar index off,
         auto-built and read, each equal to a numpy f64 oracle;
       collect: -o over LAST (the box, class 6 and the time range, both
         transports, index off and read: auto-built for the box, exact for
         class and time) and LAZER (one run per predicate, and a
         --print-points run); every written LAS file, read back, holds
         exactly the numpy oracle's matches of its input file in file
         order; the LAZER outputs and printed text are byte-identical to
         the port's --device cpu run; one run_query(force_collect=True) of
         the LAST box, with no sink, counts the oracle's matches;
       class: --class 6 (mixed blocks) and --class 4 (absent) in both
         transports with the index off and exact (built as the index
         command builds it), plus one u8-row run at a block size with
         B % 4 == 2, each equal to a numpy oracle;
       time: a --time-range that straddles files, in both transports with
         the index off and exact, each equal to a numpy f64 oracle;
       probe: the bbox probe tool at 2^24 points, every bbox row equal;
     every kernel of a path must have launched in it

It prints the nvidia-smi line and a JSON object of per-kernel numbers on the
lines before the last, and {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from adhoc_queries_pointclouds_torch import _build, cli, engine, host
from adhoc_queries_pointclouds_torch.host import packed_row_width
from adhoc_queries_pointclouds_torch.ops import compact as C
from adhoc_queries_pointclouds_torch.ops import predicate as P
from adhoc_queries_pointclouds_torch.shared import (
    BoundsQuery,
    QueryPlan,
    encode_point_records,
    index,
    make_writeback_header,
    open_point_cloud,
    parse_aabb,
    synth,
)
from adhoc_queries_pointclouds_torch.tools import bboxprobe

SEED = 20261016
K, B = 4, 1 << 21  # AQPC_BLOCKS_PER_STEP blocks of DEFAULT_BLOCK_SIZE points
PACKED_WIDTHS = (0, 4, 12, 20, 28, 32)
TIMED_RUNS = 25
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# Boxes over the generated datasets (files at x offsets 100000 + 1000 i,
# 1000 x 1000 x 100 m each): one straddles files 0-5, the other 0-1.
E2E_BOX_LARGE = "100500;200250;0;105700;200876;80"
E2E_BOX_SMALL = "100500;200250;0;101700;200876;80"
# GPS times run on one flight line at 200k points/s, so a file of 8M points
# spans 40 s and one of 2M points 10 s: each range straddles file boundaries.
E2E_TIME_LARGE = (52.5, 181.25)
E2E_TIME_SMALL = (7.5, 13.25)
# a selective box over LAZER file 0 for the --print-points run
E2E_BOX_PRINT = "100500;200250;0;100560;200330;80"
FORMATS = ("las", "last", "lazer", "laz")
DENSITIES = (0.0, 0.001, 0.5, 1.0)  # hit share of block k in the collect cases
PROBE_N = 1 << 24  # the probe tool's --n
_TPU = "adhoc_queries_pointclouds_tpu/"
# kernel -> (source, the Pallas kernel or XLA-fused function it replaces);
# all sources are CUDA C++
KERNELS = {
    "bbox_count_multi": ("bbox_count.cu", _TPU + "ops/predicate.py:281"),
    "bbox_count_packed": ("bbox_count_packed.cu", _TPU + "ops/predicate.py:499"),
    "class_count_multi": ("class_count.cu", _TPU + "ops/predicate.py:336"),
    "class_count_words": ("class_count.cu", _TPU + "ops/predicate.py:733"),
    "class_count_dict": ("class_count_dict.cu", _TPU + "ops/predicate.py:597"),
    "time_count_multi": ("time_count.cu", _TPU + "ops/predicate.py:235"),
    "time_count_packed": ("time_count.cu", _TPU + "ops/predicate.py:529"),
    "mask_bbox": ("mask_bits.cu", _TPU + "ops/predicate.py:261"),
    "mask_bbox_packed": ("mask_bits.cu", _TPU + "ops/predicate.py:508"),
    "mask_class": ("mask_bits.cu", _TPU + "ops/predicate.py:247"),
    "mask_class_dict": ("mask_bits.cu", _TPU + "ops/predicate.py:604"),
    "mask_time": ("mask_bits.cu", _TPU + "ops/predicate.py:235"),
    "mask_time_packed": ("mask_bits.cu", _TPU + "ops/predicate.py:537"),
    "compact_bits": ("compact_bits.cu", _TPU + "ops/compact.py:86"),
    "bbox_probe_acc": ("bbox_probe.cu", "tools/bboxprobe.py:60"),
    "bbox_probe_acc_nomask": ("bbox_probe.cu", "tools/bboxprobe.py:87"),
}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def phase_env() -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    smi = smi_line()
    print(f"card: {smi}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], check=True, capture_output=True, text=True)
    print(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    print(f"built {_build.library_path()} in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------- phase 3


class Timer:
    """Median device time of one call: CUDA events around each run, with
    the 50 MB L2 flushed before it so every run reads from device memory."""

    def __init__(self, dev):
        self._flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        fn()  # warm
        times = []
        for _ in range(TIMED_RUNS):
            self._flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rand_i32(gen, shape, dev, lo=I32_MIN, hi=I32_MAX) -> torch.Tensor:
    """Uniform int32 in [lo, hi], made on the card."""
    span = hi - lo + 1
    v = torch.randint(0, span, shape, dtype=torch.int64, device=dev, generator=gen)
    return (v + lo).to(torch.int32)


def compare(name, kernel_fn, plain_fn, errs) -> None:
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    errs.append(err)
    print(f"  {name}: kernel {got.tolist()} plain {want.tolist()} max_abs_err {err}")
    if got.shape != want.shape or err != 0:
        fail(f"{name}: kernel disagrees with its plain version")


def timed(timer, kernel_fn, plain_fn, nbytes: float, indent: str = "  ",
          what: str = f"{K} full blocks") -> tuple:
    """Kernel and plain times at the main path's shape, with bytes moved/s."""
    ms = timer.ms(kernel_fn)
    plain_ms = timer.ms(plain_fn)
    print(f"{indent}time, {what}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
          f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s)")
    return ms, plain_ms


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {}

    # kernel 1: bbox_count_multi over raw int32 xyz
    errs: list[int] = []
    xs, ys, zs = (rand_i32(gen, (K, B), dev) for _ in range(3))
    full_lo = torch.full((K, 3), I32_MIN, **i32)
    full_hi = torch.full((K, 3), I32_MAX, **i32)
    box_lo = rand_i32(gen, (K, 3), dev, I32_MIN, 0)
    box_hi = rand_i32(gen, (K, 3), dev, 0, I32_MAX)
    nv_full = torch.full((K,), B, **i32)
    nv_edges = torch.tensor([0, 1, B - 1, B], **i32)
    cases = [
        ("full-range box", (xs, ys, zs, full_lo, full_hi, nv_full)),
        ("random boxes", (xs, ys, zs, box_lo, box_hi, nv_full)),
        ("empty boxes", (xs, ys, zs, full_hi, full_lo, nv_full)),
        ("n_valid 0, 1, B-1, B", (xs, ys, zs, box_lo, box_hi, nv_edges)),
    ]
    print(f"bbox_count_multi, K={K}, B={B}:")
    for name, args in cases:
        compare(name, lambda: P.bbox_count_multi_kernel(*args), lambda: P.bbox_count_multi(*args),
                errs)
    bu = B - 8192 + 3
    ux, uy, uz = (t.reshape(-1)[: K * bu].view(K, bu) for t in (xs, ys, zs))
    nv_u = torch.tensor([bu, bu - 1, 4097, 0], **i32)
    compare(f"unaligned B={bu}", lambda: P.bbox_count_multi_kernel(ux, uy, uz, box_lo, box_hi, nv_u),
            lambda: P.bbox_count_multi(ux, uy, uz, box_lo, box_hi, nv_u), errs)
    one = (xs[1], ys[1], zs[1], box_lo[1], box_hi[1], nv_full[1])
    compare("K=1 (bbox_count)", lambda: P.bbox_count(*one).reshape(1),
            lambda: P.bbox_count_multi(*(t[None] for t in one[:5]), nv_full[1:2]), errs)
    args = cases[1][1]
    ms, plain_ms = timed(timer, lambda: P.bbox_count_multi_kernel(*args),
                         lambda: P.bbox_count_multi(*args), 12 * K * B)
    out["bbox_count_multi"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    # kernel 2: bbox_count_packed over bit-planar residual planes
    errs = []
    print(f"bbox_count_packed, K={K}, B={B}:")
    nvs = torch.tensor([B, B - 5, 777, 0], **i32)  # the last row is padding
    times = {}
    for widths in [(w, w, w) for w in PACKED_WIDTHS] + [(12, 20, 28)]:
        planes = [
            torch.randint(0, 256, (K, packed_row_width(w, B)), dtype=torch.uint8, device=dev,
                          generator=gen)
            for w in widths
        ]
        # residual-space bounds: per-block boxes inside [0, 2^w) (any int32
        # at w = 32), as per-block bases give them; padding lo 0, hi -1
        tops = [(1 << w) - 1 if w < 32 else I32_MAX for w in widths]
        bots = [0 if w < 32 else I32_MIN for w in widths]
        a = torch.stack([rand_i32(gen, (K,), dev, b, t) for b, t in zip(bots, tops)], 1)
        c = torch.stack([rand_i32(gen, (K,), dev, b, t) for b, t in zip(bots, tops)], 1)
        lo, hi = torch.minimum(a, c), torch.maximum(a, c)
        lo[-1], hi[-1] = 0, -1
        args = (*planes, lo, hi, nvs, widths, B)
        compare(f"widths {widths}", lambda: P.bbox_count_packed_kernel(*args),
                lambda: P.bbox_count_packed_multi(*args), errs)
        # timed as the main path runs it: K full blocks
        args = (*planes, lo, hi, nv_full, widths, B)
        times[widths] = timed(timer, lambda: P.bbox_count_packed_kernel(*args),
                              lambda: P.bbox_count_packed_multi(*args),
                              sum(widths) / 8 * K * B, "    ")
    ms, plain_ms = times[(20, 20, 20)]  # the widths of the e2e datasets' blocks
    out["bbox_count_packed"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    kernels_class(dev, gen, timer, out)
    kernels_time(dev, gen, timer, out)
    kernels_collect(dev, gen, timer, out)
    kernels_probe(dev, gen, timer, out)
    return out


def kernels_class(dev, gen, timer, out) -> None:
    """The u8 and word class entries, their K=1 forms, and the dictionary
    entry; exact equality with the plain versions."""
    i32 = dict(dtype=torch.int32, device=dev)
    targets = torch.tensor([0, 6, 255, 6], **i32)
    cls = torch.randint(0, 256, (K, B), dtype=torch.uint8, device=dev, generator=gen)
    hit = torch.rand((K, B), device=dev, generator=gen) < 0.3
    cls = torch.where(hit, targets[:, None].to(torch.uint8), cls)
    words = cls.view(torch.int32)
    nv_cases = [
        ("n_valid B, B-1, B-2, B-3", torch.tensor([B, B - 1, B - 2, B - 3], **i32)),
        ("n_valid 0, 1, B-1, B", torch.tensor([0, 1, B - 1, B], **i32)),
        ("n_valid 2, 3, 4, 5", torch.tensor([2, 3, 4, 5], **i32)),
    ]
    nv_full = torch.full((K,), B, **i32)
    for name, col, kernel, plain in (
        ("class_count_multi", cls, P.class_count_multi_kernel, P.class_count_multi),
        ("class_count_words", words, P.class_count_words_kernel, P.class_count_packed_multi),
    ):
        errs: list[int] = []
        print(f"{name}, K={K}, B={B}, targets {targets.tolist()}:")
        for label, nvs in nv_cases:
            compare(label, lambda: kernel(col, targets, nvs), lambda: plain(col, targets, nvs), errs)
        if name == "class_count_multi":
            bu = B - 2  # rows off 16-byte boundaries, B % 4 == 2
            ucls = cls.reshape(-1)[: K * bu].view(K, bu)
            nv_u = torch.tensor([bu, bu - 1, 4097, 0], **i32)
            compare(f"unaligned B={bu}", lambda: kernel(ucls, targets, nv_u),
                    lambda: plain(ucls, targets, nv_u), errs)
            compare("K=1 (class_count)",
                    lambda: P.class_count(cls[1], targets[1], nv_cases[0][1][1]).reshape(1),
                    lambda: plain(cls[1:2], targets[1:2], nv_cases[0][1][1:2]), errs)
        else:
            compare("K=1 (class_count_packed)",
                    lambda: P.class_count_packed(words[2], targets[2], nv_cases[0][1][2]).reshape(1),
                    lambda: plain(words[2:3], targets[2:3], nv_cases[0][1][2:3]), errs)
        ms, plain_ms = timed(timer, lambda: kernel(col, targets, nv_full),
                             lambda: plain(col, targets, nv_full), K * B)
        out[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    errs = []
    print(f"class_count_dict, K={K}, B={B}:")
    nvs = torch.tensor([B, B - 5, 777, 0], **i32)  # the last row is padding
    times = {}
    for k in (1, 2, 4, 8):
        cp = torch.randint(0, 256, (K, packed_row_width(k, B)), dtype=torch.uint8, device=dev,
                           generator=gen)
        codes = torch.tensor([0, (1 << k) - 1, 1 << k, (1 << k) // 2], **i32)  # 1 << k: a miss
        compare(f"k={k}, target codes {codes.tolist()}",
                lambda: P.class_count_dict_kernel(cp, codes, nvs, k, B),
                lambda: P.class_count_dict_multi(cp, codes, nvs, k, B), errs)
        times[k] = timed(timer, lambda: P.class_count_dict_kernel(cp, codes, nv_full, k, B),
                         lambda: P.class_count_dict_multi(cp, codes, nv_full, k, B),
                         k / 8 * K * B, "    ")
    ms, plain_ms = times[2]  # blocks of the e2e datasets hold at most 4 classes
    out["class_count_dict"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def kernels_time(dev, gen, timer, out) -> None:
    """The raw and packed GPS-time entries on encoded words that cross the
    int32 sign boundary, with equal hi words and empty ranges."""
    i32 = dict(dtype=torch.int32, device=dev)
    nv_full = torch.full((K,), B, **i32)
    ths, tls = rand_i32(gen, (K, B), dev), rand_i32(gen, (K, B), dev)
    ths[1] = 12345  # equal hi words: the lo words decide
    edges = torch.tensor([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX], **i32)
    pick = torch.randint(0, len(edges), (2, B), device=dev, generator=gen)
    ths[2], tls[2] = edges[pick[0]], edges[pick[1]]  # values at the sign boundary
    lo_h, lo_l = rand_i32(gen, (K,), dev), rand_i32(gen, (K,), dev)
    hi_h, hi_l = rand_i32(gen, (K,), dev), rand_i32(gen, (K,), dev)
    q_rand = torch.stack([torch.minimum(lo_h, hi_h), lo_l, torch.maximum(lo_h, hi_h), hi_l], 1)
    q_rand[1] = torch.tensor([12345, -(2**30), 12345, 2**30], **i32)
    q_edges = torch.tensor([[I32_MIN, I32_MIN, I32_MAX, I32_MAX], [-1, I32_MAX, 0, 1],
                            [-1, 0, 1, 0], [0, I32_MIN, 0, I32_MAX]], **i32)
    q_empty = torch.stack([lo_h, lo_l, lo_h, lo_l], 1)  # start == end
    cases = [
        ("random ranges", q_rand, nv_full),
        ("sign-boundary ranges", q_edges, nv_full),
        ("empty ranges", q_empty, nv_full),
        ("n_valid 0, 1, B-1, B", q_edges, torch.tensor([0, 1, B - 1, B], **i32)),
    ]
    errs: list[int] = []
    print(f"time_count_multi, K={K}, B={B}:")
    for name, qs, nvs in cases:
        compare(name, lambda: P.time_count_multi_kernel(ths, tls, qs, nvs),
                lambda: P.time_count_multi(ths, tls, qs, nvs), errs)
    ms, plain_ms = timed(timer, lambda: P.time_count_multi_kernel(ths, tls, q_rand, nv_full),
                         lambda: P.time_count_multi(ths, tls, q_rand, nv_full), 8 * K * B)
    out["time_count_multi"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    errs = []
    print(f"time_count_packed, K={K}, B={B}:")
    nvs = torch.tensor([B, B - 5, 777, 0], **i32)  # the last row is padding
    times = {}
    for widths in [(w, w) for w in PACKED_WIDTHS] + [(20, 32), (4, 28)]:
        planes = [torch.randint(0, 256, (K, packed_row_width(w, B)), dtype=torch.uint8,
                                device=dev, generator=gen) for w in widths]
        # residual-space ranges inside [0, 2^w) (any int32 at w = 32), and a
        # saturated row as the host's clip makes it for a far query
        qw = []
        for w in widths:
            top, bot = ((1 << w) - 1, 0) if w < 32 else (I32_MAX, I32_MIN)
            a, c = rand_i32(gen, (K,), dev, bot, top), rand_i32(gen, (K,), dev, bot, top)
            qw.append((torch.minimum(a, c), torch.maximum(a, c)))
        qs = torch.stack([qw[0][0], qw[1][0], qw[0][1], qw[1][1]], 1)
        qs[2] = torch.tensor([I32_MIN, I32_MIN, I32_MAX, I32_MAX], **i32)
        compare(f"widths {widths}", lambda: P.time_count_packed_kernel(*planes, qs, nvs, widths, B),
                lambda: P.time_count_packed_multi(*planes, qs, nvs, widths, B), errs)
        times[widths] = timed(
            timer, lambda: P.time_count_packed_kernel(*planes, qs, nv_full, widths, B),
            lambda: P.time_count_packed_multi(*planes, qs, nv_full, widths, B),
            sum(widths) / 8 * K * B, "    ")
    ms, plain_ms = times[(20, 32)]  # about the widths of the e2e datasets' blocks
    out["time_count_packed"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def partial_offsets(counts, nvs, block_size) -> tuple:
    """The engine's offsets: blocks with some but not all valid rows hit get
    consecutive offsets, every other block -1; and the total."""
    offsets, total = [], 0
    for c, nv in zip(counts, nvs):
        nv = min(max(nv, 0), block_size)
        offsets.append(total if 0 < c < nv else -1)
        total += c if 0 < c < nv else 0
    return offsets, total


def compare_collect(name, kernel_fn, plain_fn, nvs, block_size, errs, want_counts=None) -> tuple:
    """One bit-mask entry against its plain version (words, counts, chunk
    counts), then the compaction of its partial blocks against the plain
    compaction. Returns the kernel's mask and the compaction's operands."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    same_shape = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    mask_err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if w.numel() else 0
                   for g, w in zip(got, want))
    counts = want.counts.tolist()
    offsets, total = partial_offsets(counts, nvs.tolist(), block_size)
    off = torch.tensor(offsets, dtype=torch.int64, device=got.bits.device)
    idx = C.compact_bits(got.bits, got.chunks, off, total, block_size)
    torch.cuda.synchronize()
    ref = C.compact_bits_plain(want.bits, want.chunks, off, total, block_size)
    idx_err = int((idx.to(torch.int64) - ref.to(torch.int64)).abs().max()) if total else 0
    errs["mask"].append(mask_err)
    errs["compact"].append(idx_err)
    print(f"  {name}: counts kernel {got.counts.tolist()} plain {counts}, {total} hits "
          f"compacted; max_abs_err mask {mask_err}, indices {idx_err}")
    if not same_shape or mask_err or idx_err or idx.shape != ref.shape:
        fail(f"{name}: kernel disagrees with its plain version")
    if want_counts is not None and counts != want_counts:
        fail(f"{name}: counts {counts}, built with {want_counts}")
    return got, off, total


def hit_rows(gen, dev, block_size: int) -> torch.Tensor:
    """(K, B) bool, block k's rows hit at DENSITIES[k]."""
    dens = torch.tensor(DENSITIES, device=dev)
    return torch.rand((K, block_size), device=dev, generator=gen) < dens[:, None]


def res_range(k: int, frac: float) -> tuple:
    """A residual-space [lo, hi] holding about frac of uniform k-bit
    residuals (all int32 at k = 32); frac 0 is the padding row's (0, -1)."""
    if frac == 0:
        return 0, -1
    bot = 0 if k < 32 else I32_MIN
    return bot, min(bot + max(1, round(frac * (1 << k))) - 1, I32_MAX)


def unaligned(t: torch.Tensor, bu: int) -> torch.Tensor:
    """The first K * bu elements of t as (K, bu): rows off 16-byte bounds."""
    return t.reshape(-1)[: K * bu].view(K, bu)


def kernels_collect(dev, gen, timer, out) -> None:
    """Every bit-mask entry (mask_bits.cu) and the compaction
    (compact_bits.cu) against their plain versions."""
    i32 = dict(dtype=torch.int32, device=dev)
    nv_full = torch.full((K,), B, **i32)
    nv_edges = torch.tensor([0, 1, B - 1, B], **i32)
    bu = B - 8192 + 3  # B % 8 == 3: byte planes only, rows unaligned
    nv_u = torch.tensor([bu, bu - 1, 4097, 0], **i32)
    compact_errs: list[int] = []
    hit = hit_rows(gen, dev, B)
    want = hit.sum(1).tolist()

    def raw_kind(name, args, kernel, plain, nbytes):
        errs = {"mask": [], "compact": compact_errs}
        print(f"{name}, K={K}, B={B}, hit densities {DENSITIES}:")
        full = args(nv_full)
        mask, off, total = compare_collect("n_valid B", lambda: kernel(*full),
                                           lambda: P.pack_mask_bits(plain(*full)), nv_full, B,
                                           errs, want)
        edge = args(nv_edges)
        compare_collect("n_valid 0, 1, B-1, B", lambda: kernel(*edge),
                        lambda: P.pack_mask_bits(plain(*edge)), nv_edges, B, errs)
        un = tuple(unaligned(t, bu) if t.shape == (K, B) else t for t in args(nv_u)[:-1])
        un += (nv_u,)
        compare_collect(f"unaligned B={bu}", lambda: kernel(*un),
                        lambda: P.pack_mask_bits(plain(*un)), nv_u, bu, errs)
        ms, plain_ms = timed(timer, lambda: kernel(*full), lambda: P.pack_mask_bits(plain(*full)),
                             nbytes * K * B + K * B / 8)
        out[name] = dict(max_abs_err=max(errs["mask"]), ms=ms, plain_ms=plain_ms)
        return mask, off, total

    # raw bbox: rows hit by construction, y and z always inside
    inside = dict(lo=-(2**29), hi=2**29)
    xs = torch.where(hit, rand_i32(gen, (K, B), dev, **inside),
                     rand_i32(gen, (K, B), dev, 2**29 + 1, I32_MAX))
    ys, zs = (rand_i32(gen, (K, B), dev, **inside) for _ in range(2))
    lo = torch.full((K, 3), -(2**29), **i32)
    hi = torch.full((K, 3), 2**29, **i32)
    mask, off, total = raw_kind("mask_bbox", lambda nv: (xs, ys, zs, lo, hi, nv),
                                P.bbox_mask_bits, P.bbox_mask_multi, 12)
    print(f"compact_bits, blocks at densities {DENSITIES[1:3]} (the partial ones):")
    ms, plain_ms = timed(
        timer, lambda: C.compact_bits(mask.bits, mask.chunks, off, total, B),
        lambda: C.compact_bits_plain(mask.bits, mask.chunks, off, total, B),
        2 * B / 8 + 4 * total, what=f"{total} hits of 2 blocks")
    compact_times = (ms, plain_ms)
    del xs, ys, zs

    cls = torch.where(hit, 6, torch.randint(7, 256, (K, B), device=dev, generator=gen))
    cls = cls.to(torch.uint8)
    targets = torch.full((K,), 6, **i32)
    raw_kind("mask_class", lambda nv: (cls, targets, nv), P.class_mask_bits, P.class_mask_multi, 1)
    del cls

    # raw time: hit rows have hi word -1, the others hi >= 0 (the sign
    # boundary); q = [(-1, INT_MIN), (0, INT_MIN)) takes exactly hi == -1
    ths = torch.where(hit, -1, rand_i32(gen, (K, B), dev, 0, I32_MAX)).to(torch.int32)
    tls = rand_i32(gen, (K, B), dev)
    qs = torch.tensor([[-1, I32_MIN, 0, I32_MIN]] * K, **i32)
    raw_kind("mask_time", lambda nv: (ths, tls, qs, nv), P.time_mask_bits, P.time_mask_multi, 8)
    del ths, tls

    def packed_kind(name, label, make, kernel, plain, nbytes, main_case, cases, unaligned_case):
        errs = {"mask": [], "compact": compact_errs}
        print(f"{name}, K={K}, B={B}, hit densities about {DENSITIES}:")
        times = {}
        for case in cases:
            full = make(case, B, nv_full)
            compare_collect(f"{label} {case}, n_valid B", lambda: kernel(*full),
                            lambda: P.pack_mask_bits(plain(*full)), nv_full, B, errs)
            edge = make(case, B, nv_edges)
            compare_collect(f"{label} {case}, n_valid 0, 1, B-1, B", lambda: kernel(*edge),
                            lambda: P.pack_mask_bits(plain(*edge)), nv_edges, B, errs)
            times[case] = timed(timer, lambda: kernel(*full),
                                lambda: P.pack_mask_bits(plain(*full)),
                                (nbytes(case) + 1 / 8) * K * B, "    ")
        un = make(unaligned_case, bu, nv_u)
        compare_collect(f"{label} {unaligned_case}, unaligned B={bu}", lambda: kernel(*un),
                        lambda: P.pack_mask_bits(plain(*un)), nv_u, bu, errs)
        ms, plain_ms = times[main_case]
        out[name] = dict(max_abs_err=max(errs["mask"]), ms=ms, plain_ms=plain_ms)

    def planes(w, block_size):
        return torch.randint(0, 256, (K, packed_row_width(w, block_size)), dtype=torch.uint8,
                             device=dev, generator=gen)

    def bbox_case(widths, block_size, nvs):
        # x holds the block's density, y and z take every residual
        rows = [[res_range(widths[0], d), res_range(widths[1], 1), res_range(widths[2], 1)]
                for d in DENSITIES]
        lo = torch.tensor([[a[0] for a in r] for r in rows], **i32)
        hi = torch.tensor([[a[1] for a in r] for r in rows], **i32)
        return (*(planes(w, block_size) for w in widths), lo, hi, nvs, widths, block_size)

    packed_kind("mask_bbox_packed", "widths", bbox_case, P.bbox_mask_bits_packed,
                P.bbox_mask_packed_multi, lambda w: sum(w) / 8, (20, 20, 20),
                [(w, w, w) for w in PACKED_WIDTHS] + [(12, 20, 28)], (8, 16, 32))

    def time_case(widths, block_size, nvs):
        # the hi residual in [bot, bot + density * 2^k_hi); the lo residual
        # never decides (its lowest value bounds both ends)
        kh, kl = widths
        low = 0 if kl < 32 else I32_MIN
        rows = []
        for d in DENSITIES:
            if d == 0:
                rows.append([0, 0, 0, 0])  # start == end
            elif d == 1:
                rows.append([I32_MIN, I32_MIN, I32_MAX, I32_MAX])
            else:
                bot, top = res_range(kh, d)
                rows.append([bot, low, top + 1, low])
        qs = torch.tensor(rows, **i32)
        return (planes(kh, block_size), planes(kl, block_size), qs, nvs, widths, block_size)

    packed_kind("mask_time_packed", "widths", time_case, P.time_mask_bits_packed,
                P.time_mask_packed_multi, lambda w: sum(w) / 8, (20, 32),
                [(w, w) for w in PACKED_WIDTHS] + [(20, 32), (4, 28)], (16, 32))

    def dict_case(k, block_size, nvs):
        # codes: a miss (len(dict)), two codes at 2^-k, and a block of code 0
        cp = planes(k, block_size)
        cp[3] = 0
        codes = torch.tensor([1 << k, 0, 1, 0], **i32)
        return (cp, codes, nvs, k, block_size)

    packed_kind("mask_class_dict", "k", dict_case, P.class_mask_bits_dict,
                P.class_mask_dict_multi, lambda k: k / 8, 2, [1, 2, 4, 8], 8)

    ms, plain_ms = compact_times
    out["compact_bits"] = dict(max_abs_err=max(compact_errs), ms=ms, plain_ms=plain_ms)


def kernels_probe(dev, gen, timer, out) -> None:
    """The bbox probe variants (bbox_probe.cu) at the probe tool's size."""
    i32 = dict(dtype=torch.int32, device=dev)
    n = PROBE_N
    x, y, z = (rand_i32(gen, (n,), dev, -(2**30), 2**30) for _ in range(3))
    lo = torch.full((3,), -(2**29), **i32)
    hi = torch.full((3,), 2**29, **i32)
    errs: list[int] = []
    print(f"bbox_probe_acc, n={n}:")
    for nv in (n, n - 5, 1, 0):
        nvt = torch.tensor(nv, **i32)
        compare(f"n_valid {nv}", lambda: P.bbox_probe_acc_kernel(x, y, z, lo, hi, nvt).reshape(1),
                lambda: P.bbox_probe_acc(x, y, z, lo, hi, nvt).reshape(1), errs)
    nvt = torch.tensor(n, **i32)
    ms, plain_ms = timed(timer, lambda: P.bbox_probe_acc_kernel(x, y, z, lo, hi, nvt),
                         lambda: P.bbox_probe_acc(x, y, z, lo, hi, nvt), 12 * n,
                         what=f"{n} points")
    out["bbox_probe_acc"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    errs = []
    print(f"bbox_probe_acc_nomask, n={n}:")
    compare("aligned", lambda: P.bbox_probe_acc_nomask_kernel(x, y, z, lo, hi).reshape(1),
            lambda: P.bbox_probe_acc_nomask(x, y, z, lo, hi).reshape(1), errs)
    compare("columns off 16-byte bounds",
            lambda: P.bbox_probe_acc_nomask_kernel(x[1:], y[1:], z[1:], lo, hi).reshape(1),
            lambda: P.bbox_probe_acc_nomask(x[1:], y[1:], z[1:], lo, hi).reshape(1), errs)
    ms, plain_ms = timed(timer, lambda: P.bbox_probe_acc_nomask_kernel(x, y, z, lo, hi),
                         lambda: P.bbox_probe_acc_nomask(x, y, z, lo, hi), 12 * n,
                         what=f"{n} points")
    out["bbox_probe_acc_nomask"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------- phase 4


def point_files(data_dir: Path) -> list[Path]:
    return [f for f in sorted(data_dir.iterdir()) if f.suffix.lstrip(".") in FORMATS]


def column_oracle(data_dir: Path, match) -> int:
    """Sum over the files of count_nonzero(match(reader))."""
    total = 0
    for f in point_files(data_dir):
        r = open_point_cloud(f)
        total += int(np.count_nonzero(match(r)))
        r.close()
    return total


def oracle(data_dir: Path, box: str) -> int:
    aabb = parse_aabb(box)
    return column_oracle(data_dir, lambda r: aabb.contains_points(r.positions_world()))


def run_cli(args: list[str], pack: str) -> str:
    os.environ["AQPC_PACK"] = pack
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue()
    if rc != 0:
        fail(f"cli {' '.join(args)} exited {rc}:\n{out}")
    return out


def cli_count(data_dir: Path, query: list[str], pack: str, use_index: bool, want: int) -> str:
    """One CLI count on the card; its count must equal the oracle's."""
    args = ["-i", str(data_dir), *query, "--device", "cuda", "--stats"]
    if not use_index:
        args.append("--no-index")
    out = run_cli(args, pack)
    found = int(re.search(r"^Found (\d+) matching points$", out, re.M).group(1))
    mpts = re.search(r"\(([\d.]+) Mpts/s\)", out).group(1)
    tail = out.strip().splitlines()[-1]
    idx = "on " if use_index else "off"
    print(f"  {' '.join(query)} AQPC_PACK={pack} index {idx}: found {found}, {mpts} Mpts/s; "
          f"{tail}")
    for line in out.splitlines()[2:-1]:
        print(f"      {line.strip()}")
    if found != want:
        fail(f"{data_dir.name} {' '.join(query)} AQPC_PACK={pack} index={use_index}: "
             f"found {found}, oracle {want}")
    return out


def pruned_points(out: str) -> int:
    m = re.search(r"^\s*index_pruned_points: (\d+)$", out, re.M)
    return int(m.group(1)) if m else 0


def make_datasets(root: Path) -> list[tuple]:
    t0 = time.perf_counter()
    synth.write_dataset(root / "big", n_files=8, points_per_file=8_000_000, seed=SEED,
                        formats=("las", "last"), clustered=True, point_format=3)
    synth.write_dataset(root / "small", n_files=2, points_per_file=2_000_000, seed=SEED,
                        formats=("lazer", "laz"), clustered=True, point_format=3)
    print(f"datasets written in {time.perf_counter() - t0:.1f} s")
    datasets = [(root / "big" / f, E2E_BOX_LARGE, E2E_TIME_LARGE, 64_000_000)
                for f in ("last", "las")]
    datasets += [(root / "small" / f, E2E_BOX_SMALL, E2E_TIME_SMALL, 4_000_000)
                 for f in ("lazer", "laz")]
    return datasets


def build_exact_indexes(datasets) -> None:
    """Exact sidecars (class bitmaps, GPS min/max) over every file, as the
    index command builds them; they replace the bbox path's auto-built ones,
    which prune nothing for class and time plans."""
    for data_dir, *_ in datasets:
        t0 = time.perf_counter()
        for f in point_files(data_dir):
            r = open_point_cloud(f)
            mm, bitmap, gps = index.build_index(r)
            index.save_index(f, mm, bitmap, gps, n_points=r.point_count)
            r.close()
        print(f"{data_dir.name}: exact index built in {time.perf_counter() - t0:.1f} s")


def path_bbox(datasets) -> None:
    runs = [("1", False), ("0", False), ("1", True), ("1", True), ("0", True)]
    for data_dir, box, _, n_points in datasets:
        want = oracle(data_dir, box)
        print(f"{data_dir.name}: {n_points} points, bbox oracle {want} matching")
        for pack, use_index in runs:
            cli_count(data_dir, ["--bounds", box], pack, use_index, want)


def path_class(datasets) -> None:
    runs = [("1", False), ("0", False), ("1", True), ("0", True)]
    for data_dir, _, _, n_points in datasets:
        for target in (6, 4):
            want = column_oracle(data_dir, lambda r: r.column("classification") == target)
            print(f"{data_dir.name}: {n_points} points, class {target} oracle {want} matching")
            for pack, use_index in runs:
                out = cli_count(data_dir, ["--class", str(target)], pack, use_index, want)
                if use_index and target == 4 and pruned_points(out) != n_points:
                    fail(f"{data_dir.name}: the exact index did not prune the absent class")
            if target == 6 and data_dir == datasets[0][0]:
                # u8 rows: a block size with B % 4 == 2 cannot be viewed as words
                cli_count(data_dir, ["--class", "6", "--block-size", str(B - 2)], "0", False, want)


def path_time(datasets) -> None:
    runs = [("1", False), ("0", False), ("1", True), ("0", True)]
    for data_dir, _, (t0, t1), n_points in datasets:
        def match(r):
            g = r.column("gps_time")
            return (g >= t0) & (g < t1)

        want = column_oracle(data_dir, match)
        print(f"{data_dir.name}: {n_points} points, time [{t0}, {t1}) oracle {want} matching")
        for pack, use_index in runs:
            out = cli_count(data_dir, ["--time-range", f"{t0};{t1}"], pack, use_index, want)
            if use_index and pruned_points(out) == 0:
                fail(f"{data_dir.name}: the exact index did not prune the time range")


def written_oracle(data_dir: Path, match) -> list:
    """The numpy oracle of a collect: for each input file with hits, in file
    order, the write-back header and the LAS point records of exactly its
    matches, in file order."""
    want = []
    for f in point_files(data_dir):
        r = open_point_cloud(f)
        m = match(r)
        if m.any():
            pos = r.positions_world()[m]
            header = make_writeback_header(len(pos), pos.min(0), pos.max(0), point_format=2)
            recs = encode_point_records(header, pos, r.column("classification")[m],
                                        r.column("color")[m], r.column("intensity")[m])
            want.append((header, recs))
        r.close()
    return want


def check_written(out: str, want: list, label: str) -> list[Path]:
    """Every "Wrote" file, read back with the shared readers, holds the
    oracle's points of its input file, in order."""
    wrote = [Path(p) for p in re.findall(r"^Wrote (.+)$", out, re.M)]
    if [p.name for p in wrote] != [f"matching_points_{j}.las" for j in range(len(want))]:
        fail(f"{label}: wrote {[p.name for p in wrote]}, the oracle has {len(want)} files with hits")
    for path, (header, recs) in zip(wrote, want):
        r = open_point_cloud(path)
        pos = r.column("position")
        same = (r.point_count == len(recs)
                and tuple(r.header.scale) == tuple(header.scale)
                and tuple(r.header.offset) == tuple(header.offset)
                and all(np.array_equal(pos[:, j], recs[a]) for j, a in enumerate("xyz"))
                and np.array_equal(r.column("classification"), recs["classification"])
                and np.array_equal(r.column("intensity"), recs["intensity"])
                and np.array_equal(r.column("color"),
                                   np.stack([recs["red"], recs["green"], recs["blue"]], 1)))
        r.close()
        if not same:
            fail(f"{label}: {path.name} is not the oracle's matches of its input file")
    return wrote


def cli_collect(data_dir: Path, query: list[str], pack: str, use_index: bool, want: list,
                out_dir: Path, device: str = "cuda") -> str:
    """One CLI collect with -o; its count and every written file must equal
    the oracle's."""
    out_dir.mkdir(parents=True)
    args = ["-i", str(data_dir), *query, "--device", device, "--stats", "-o", str(out_dir)]
    if not use_index:
        args.append("--no-index")
    t0 = time.perf_counter()
    out = run_cli(args, pack)
    wall = time.perf_counter() - t0
    found = int(re.search(r"^Found (\d+) matching points$", out, re.M).group(1))
    mpts = re.search(r"\(([\d.]+) Mpts/s\)", out).group(1)
    idx = "on " if use_index else "off"
    label = f"{data_dir.name} -o {' '.join(query)} AQPC_PACK={pack} index {idx} on {device}"
    n_want = sum(len(recs) for _, recs in want)
    if found != n_want:
        fail(f"{label}: found {found}, oracle {n_want}")
    wrote = check_written(out, want, label)
    print(f"  {label}: found {found} in {len(wrote)} files equal to the oracle's; "
          f"{wall:.3f} s, {mpts} Mpts/s, {found / wall / 1e6:.2f} M hits/s")
    for line in out.splitlines()[2 + len(wrote):-1]:
        print(f"      {line.strip()}")
    return out


def collect_without_sink(data_dir: Path, box, want: int) -> None:
    """run_query(force_collect=True) on the card: the collect path's steps,
    bit masks, compaction, hit gather and ordered emission into a
    count-only emitter, with no LAS write-back. Its count must equal the
    oracle's, with no hits kept and no file written."""
    os.environ["AQPC_PACK"] = "1"
    t0 = time.perf_counter()
    res = engine.run_query(data_dir, QueryPlan(bounds=BoundsQuery(box)), device="cuda",
                           force_collect=True)
    wall = time.perf_counter() - t0
    label = f"{data_dir.name} run_query(force_collect=True) box AQPC_PACK=1 index on"
    if res.match_count != want or res.hits or res.output_files:
        fail(f"{label}: found {res.match_count} with {len(res.hits)} kept hits and "
             f"{len(res.output_files)} files, oracle {want} and none")
    print(f"  {label}: found {res.match_count}, no sink; {wall:.3f} s, "
          f"{res.mpts_per_s:.1f} Mpts/s, {want / wall / 1e6:.2f} M hits/s")
    for line in res.timer.report().splitlines():
        print(f"      {line.strip()}")


def path_collect(datasets) -> None:
    """-o over LAST 64M and LAZER 4M and one --print-points run. The LAST
    box runs read the sidecars the bbox path auto-built; the exact ones are
    built before the class and time runs."""
    big, small = datasets[0][0], datasets[2][0]
    box_l, box_s = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_SMALL)
    (t0_l, t1_l), (t0_s, t1_s) = E2E_TIME_LARGE, E2E_TIME_SMALL

    def in_time(t0, t1):
        def match(r):
            g = r.column("gps_time")
            return (g >= t0) & (g < t1)
        return match

    last_queries = [
        (["--bounds", E2E_BOX_LARGE], lambda r: box_l.contains_points(r.positions_world())),
        (["--class", "6"], lambda r: r.column("classification") == 6),
        (["--time-range", f"{t0_l};{t1_l}"], in_time(t0_l, t1_l)),
    ]
    lazer_queries = [
        (["--bounds", E2E_BOX_SMALL], lambda r: box_s.contains_points(r.positions_world())),
        (["--class", "6"], lambda r: r.column("classification") == 6),
        (["--time-range", f"{t0_s};{t1_s}"], in_time(t0_s, t1_s)),
    ]
    with tempfile.TemporaryDirectory(prefix="aqpc_collect_") as tmp:
        tmp = Path(tmp)
        for q, (query, match) in enumerate(last_queries):
            if q == 1:
                build_exact_indexes(datasets)
            want = written_oracle(big, match)
            print(f"{big.name}: {' '.join(query)}, oracle {sum(len(r) for _, r in want)} "
                  f"matching in {len(want)} files")
            for n, (pack, use_index) in enumerate([("1", False), ("0", False), ("1", True),
                                                   ("0", True)]):
                out_dir = tmp / f"last_{q}_{n}"
                cli_collect(big, query, pack, use_index, want, out_dir)
                shutil.rmtree(out_dir)
            if q == 0:
                collect_without_sink(big, box_l, sum(len(r) for _, r in want))
            del want
        for q, (query, match) in enumerate(lazer_queries):
            want = written_oracle(small, match)
            dirs = [tmp / f"lazer_{q}_{device}" for device in ("cuda", "cpu")]
            for device, out_dir in zip(("cuda", "cpu"), dirs):
                cli_collect(small, query, "1", True, want, out_dir, device)
            names = sorted(p.name for p in dirs[0].iterdir())
            if names != sorted(p.name for p in dirs[1].iterdir()) or not all(
                    filecmp.cmp(dirs[0] / f, dirs[1] / f, shallow=False) for f in names):
                fail(f"{small.name} -o {' '.join(query)}: the card's files differ from the CPU's")
            print(f"  {small.name} -o {' '.join(query)}: {len(names)} files byte-identical "
                  f"to the --device cpu run's")
        want = oracle(small, E2E_BOX_PRINT)
        texts = []
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out = run_cli(["-i", str(small), "--bounds", E2E_BOX_PRINT, "--device", device,
                           "--print-points"], "1")
            wall = time.perf_counter() - t0
            lines = [line for line in out.splitlines() if line.startswith("Found point: (")]
            texts.append(lines)
            print(f"  {small.name} --print-points --bounds {E2E_BOX_PRINT} on {device}: "
                  f"{len(lines)} points printed in {wall:.3f} s, oracle {want}")
            if len(lines) != want or f"Found {want} matching points" not in out:
                fail(f"{small.name} --print-points on {device}: {len(lines)} lines, oracle {want}")
        if texts[0] != texts[1]:
            fail(f"{small.name} --print-points: the card's text differs from the CPU's")


def path_probe(datasets) -> None:
    """The bbox probe tool at 2^24 points: every bbox row, the two probe
    variants among them, gives the same count (the tool raises if not)."""
    del datasets
    bboxprobe.main(["--n", str(PROBE_N), "--iters", "8", "--device", "cuda"])


# path -> (driver, the kernels it must launch)
PATHS = {
    "bbox": (path_bbox, ("bbox_count_multi", "bbox_count_packed")),
    "collect": (path_collect, ("mask_bbox", "mask_bbox_packed", "mask_class", "mask_class_dict",
                               "mask_time", "mask_time_packed", "compact_bits")),
    "class": (path_class, ("class_count_multi", "class_count_words", "class_count_dict")),
    "time": (path_time, ("time_count_multi", "time_count_packed")),
    "probe": (path_probe, ("bbox_probe_acc", "bbox_probe_acc_nomask")),
}


def main() -> int:
    seconds = {}
    t = time.perf_counter()
    phase_env()
    dev = torch.device("cuda", 0)
    seconds["environment"] = time.perf_counter() - t

    t = time.perf_counter()
    phase_build()
    seconds["build"] = time.perf_counter() - t

    t = time.perf_counter()
    kernels = phase_kernels(dev)
    seconds["kernels"] = time.perf_counter() - t

    launches = {}
    with tempfile.TemporaryDirectory(prefix="aqpc_smoke_") as tmp:
        t = time.perf_counter()
        datasets = make_datasets(Path(tmp))
        seconds["datasets"] = time.perf_counter() - t
        for name, (drive, path_kernels) in PATHS.items():
            t = time.perf_counter()
            P.reset_launches()
            drive(datasets)
            got = dict(P.launches)
            seconds[f"end to end, {name}"] = time.perf_counter() - t
            print(f"kernel launches in the {name} path: {got}")
            for kernel in path_kernels:
                if got[kernel] == 0:
                    fail(f"the {name} path never launched {kernel}")
                launches[kernel] = got[kernel]
    for name, s in seconds.items():
        print(f"phase {name}: {s:.1f} s")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": f"adhoc_queries_pointclouds_torch/csrc/{src}",
         "replaces": tpu, "launches": launches[name],
         **kernels[name]}
        for name, (src, tpu) in KERNELS.items()
    ]}
    print(smi_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

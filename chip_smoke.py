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
     the main path's shapes (K=4 blocks of 2^21 points), exact equality;
     kernel and plain times (CUDA events, median of 25 runs, L2 flushed
     before each) and the bytes read per second
  4. end to end, through the port's CLI over generated point-format-3 LAS
     and LAST datasets (8 files x 8M points) and LAZER and LAZ ones
     (2 x 2M), three paths, each with the launch counters set to 0 just
     before it and read just after:
       bbox: counts in both transports with the sidecar index off,
         auto-built and read, each equal to a numpy f64 oracle;
       class: --class 6 (mixed blocks) and --class 4 (absent) in both
         transports with the index off and exact (built as the index
         command builds it), plus one u8-row run at a block size with
         B % 4 == 2, each equal to a numpy oracle;
       time: a --time-range that straddles files, in both transports with
         the index off and exact, each equal to a numpy f64 oracle;
     every kernel of a path must have launched in it

It prints the nvidia-smi line and a JSON object of per-kernel numbers on the
lines before the last, and {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from adhoc_queries_pointclouds_torch import _build, cli, host
from adhoc_queries_pointclouds_torch.host import packed_row_width
from adhoc_queries_pointclouds_torch.ops import predicate as P
from adhoc_queries_pointclouds_torch.shared import index, open_point_cloud, parse_aabb, synth

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
FORMATS = ("las", "last", "lazer", "laz")
# kernel -> (source, replaced TPU kernel); all sources are CUDA C++
KERNELS = {
    "bbox_count_multi": ("bbox_count.cu", "ops/predicate.py:281"),
    "bbox_count_packed": ("bbox_count_packed.cu", "ops/predicate.py:499"),
    "class_count_multi": ("class_count.cu", "ops/predicate.py:336"),
    "class_count_words": ("class_count.cu", "ops/predicate.py:733"),
    "class_count_dict": ("class_count_dict.cu", "ops/predicate.py:597"),
    "time_count_multi": ("time_count.cu", "ops/predicate.py:235"),
    "time_count_packed": ("time_count.cu", "ops/predicate.py:529"),
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


def timed(timer, kernel_fn, plain_fn, nbytes: float, indent: str = "  ") -> tuple:
    """Kernel and plain times at the main path's shape, with bytes read/s."""
    ms = timer.ms(kernel_fn)
    plain_ms = timer.ms(plain_fn)
    print(f"{indent}time, {K} full blocks: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
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


# path -> (driver, the kernels it must launch)
PATHS = {
    "bbox": (path_bbox, ("bbox_count_multi", "bbox_count_packed")),
    "class": (path_class, ("class_count_multi", "class_count_words", "class_count_dict")),
    "time": (path_time, ("time_count_multi", "time_count_packed")),
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
            if name == "class":
                t = time.perf_counter()
                build_exact_indexes(datasets)
                seconds["exact indexes"] = time.perf_counter() - t
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
         "replaces": f"adhoc_queries_pointclouds_tpu/{tpu}", "launches": launches[name],
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

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100 (Hopper,
sm_90a), with nvcc on CUDA_HOME:

    python3 chip_smoke.py

Phases, in order; the first fault raises and the script exits non-zero:

  1. environment: neither jax nor the JAX package is loaded (checked again
     at the end); card name and power limit (nvidia-smi), torch, CUDA and
     nvcc versions; no CUDA device is an error
  2. build: nvcc builds the kernels of adhoc_queries_pointclouds_torch/csrc
     and g++ the host codec of native/ (no codec is an error), and the
     build's own ptxas report gives the registers, spills and shared memory
     of the kernels on the persistent tile loop (packed bbox and time pairs,
     raw time and class masks, raw class count, dictionary mask and count)
     and of the compaction; two worker processes write the end-to-end
     datasets meanwhile (`chip_smoke.py --dataset-worker`), joined before
     phase 3, so that nothing else runs beside the kernels' timings
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (K=4 blocks of 2^21 points; the probe's 2^24
     points), exact equality; kernel and plain times (tools/kernel_timer.py:
     median and least of 25 runs, L2 flushed before each; each call's time,
     "ms", and the kernel call's device work alone, "device_ms"), the bytes
     moved per second of device time, and the bound: the bytes at
     3.35 TB/s or the operations at 67 T/s, whichever is larger. The
     packed bbox and GPS-time kernels (count and mask) also run at widths
     that take each branch of their compare, with bounds or query words at
     and beyond both ends of residual space, at block sizes 2^21, 2^21 - 8
     and 2^21 - 8189, and print the floor with no planes, (0, 0, 0) or
     (0, 0), beside every width's time. The u8, word and dictionary
     class counts are timed on a target or code in every block (a
     dictionary miss stays in the compares), the u8 and dictionary counts
     also at K = 64 blocks of 2^21 (a resident dataset's one launch), and
     one call of each is split into the profiler's kernels; the timer's
     own floor is one empty kernel, and nothing, between its events. The
     collect
     kernels (one bit-mask entry per collect kind, and the ordered
     compaction of the partial blocks' hits) run at hit densities 0, 0.1 %,
     1/2 and 1, n_valid 0, 1, B-1 and B, every packed width, and an
     unaligned block size; the raw class mask also at targets -1, 0, 255,
     256, INT32_MIN and INT32_MAX on both of its load paths, and timed
     beside the dictionary mask's body at k = 8 on the same bytes; the
     packed and dictionary masks are timed on a
     range or code in every block, the dictionary mask beside its floor
     with no planes (k = 0); the compaction beside torch.nonzero on the
     same rows (its library call); one call of the raw time and class
     masks, the dictionary mask and the compaction is split into the
     profiler's kernels. The density
     kernels (per-cell leaders, then the candidates' bit mask) run raw and
     packed at the same hit densities and n_valid, over grids with about one
     and with over a hundred points per cell, over 2^32 cells, with points
     beyond the grid, at the int32 extremes, exact d2 ties and a degenerate
     axis, the table sized as the engine sizes it; the leaders (through
     ops/density.py table_leaders), the mask and the compacted indices equal
     the plain version's; then every row a hit at the 30, 10 and 4.1 m
     grids, raw and packed, held and timed by tools/density_bench.py's
     grid_case. The compaction that gathers x, y and z
     (compact_bits_gather) runs with every block skipped, blocks of 0
     hits and full blocks given offsets, a partial last mask word at a B
     no multiple of 8,192, K > 65,535 and the edges of its dense and
     sparse paths (tools/packed_bench.py gather_edges), and is timed at
     K=4 x 2^21 at the collect cases' hit densities and at a share of 0.01
     on every block, its bound counting the 32-byte sectors of x, y and z
     that the hits touch; the probe variants and the K = 1
     launch of bbox_count_multi (bbox_count, the JAX bbox_count_pallas) at
     2^24 points
  4. end to end, through the port's CLI over generated point-format-3 LAS
     and LAST datasets (8 files x 8M points) and LAZER and LAZ ones
     (2 x 2M), ten paths, each with the launch counters set to 0 just
     before it and read just after. Beside them a background worker
     (`chip_smoke.py --background-worker`, no card) does the host work
     that no path needs at once, in the order the paths take it: the
     exact sidecars, the density oracles over LAST, the experiments'
     stand-ins and oracles, paperscale's dataset and oracle; a path that
     ran beside it says so in its phase line:
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
       density: --density with -o over LAST 64M (a box in global and file
         scope, both transports, index off and read, with a cell that keeps
         most hits and one that keeps under 1 %; class 6 with no box, whose
         grid is the files' total bounds, with the exact index) and LAZER
         (one run, and a --print-points run, byte-identical to --device
         cpu); every written LAS file, read back, holds exactly the winners
         of an independent numpy f64 oracle;
       resident: the LAST 64M dataset loaded into device memory by the
         CLI's --resident: the box, class 6, class 4 and the time range
         with --repeat 20, each the oracle's count and one launch of its
         count kernel a query; -o of the box and of one second of GPS
         time, and density -o of the small box (25 m, file scope) and of
         class 6 (5 m), each the oracle's files; ms a query for each
         predicate (median of 20) in this process, with a torch.profiler
         split of one query into the kernel, the fills, the H2D of the
         query's bounds, the D2H of the counts and the host; and `serve`
         as a subprocess (info, the three counts, a collect with limit 3
         and an output dir, a line that is not JSON, quit), each reply
         the oracle's;
       devices: several devices in one process over LAST 64M, two shards
         on card 0 (run_query(devices=[cuda:0, cuda:0]) and a resident
         dataset over the same two): the box counts in both transports,
         class 6 and the time range, -o of the small box and density of
         the large box (25 m, global), the resident counts, -o of a second
         of GPS time and density of class 6 (5 m), each also at one shard;
         every answer the oracle's and the one shard's, every written file
         the oracle's; the launches on card 0 at two shards against one
         shard's (a resident count: exactly twice; a streamed step: 2 x
         ceil(n / 2)); both walls; with two cards or more, the box through
         the CLI's --devices over every card (each launches) and a kernel
         on cuda:1 while cuda:0 is current, against its plain version;
       distributed: the LAST 64M dataset queried through
         parallel/distributed.py by tools/dist2.py workers (gloo over
         tcp://127.0.0.1, each started as `chip_smoke.py --dist2-worker`,
         which checks that it loads no jax): once by one process and once
         by two processes sharing card 0, 4 files each. The box, class 6,
         class 4 and the time range in both transports, index off, each the
         oracle's count in every process; -o of the box, whose host0/ and
         host1/ files together are the oracle's (process p's j-th file is
         input file j * 2 + p of the files with hits); density -o of the
         small box at 25 m, global and file scope, and of the large box at
         25 m, global scope, whose count and winners in two processes equal
         one process's (and at file scope, and for the large box, the numpy
         oracle's files). Each query's wall in one process and in two,
         with the card's name and power limit. Then two processes of two
         shards each on card 0 (tools/dist2.py --devices 2: each process's
         steps split over two shards): the box in both transports, class 6
         and the time counts, -o of the box and density of the large box,
         each count the oracle's, each process's -o files the oracle's of
         its input files, the density winners the one process's; each
         worker's launches of a query against its launches at one shard a
         process (a count: 2 x ceil(n / 2); -o and density: the same
         kernels, each at least once); both walls. With two cards or more,
         a run over disjoint cards (cards // 2 a process) whose processes
         launch on their own cards alone; with one, a line says it was not
         run. Then the box through the CLI's --distributed --device cuda in
         two processes, and at once in two more with --devices 2, each
         one's Found line the oracle's count over 2 and 4 devices. A worker
         that fails or outlasts its timeout fails the run; the workers'
         launch counters are summed for the path's kernel check;
       drivers: the CLI's count-points over LAST 64M (64,000,000); convert
         of one 8M-point LAS file to LAST, LAZER and LAZ, each read back
         with the source's columns and its box count the oracle's; index
         over a copy of LAST 64M, then the box count reading the sidecars
         (the oracle's, points pruned); --profile DIR over the box count in
         both transports through cli.main in a fresh process (started as
         `chip_smoke.py --profile-worker`), the trace's kernel events of
         the port's kernels printed beside that process's launch counters,
         at least one event a launched kernel and, in its first trace, one
         event a launch; --devices 1 (the oracle's count), and one more
         than the cards and 0 (exit 2); the
         experiment harness over its synthetic stand-ins (4 x 2M points a
         format): experiment 2 as cold subprocesses, all sizes, full and
         max-density, the four formats at once (a harness process each),
         and experiments 4 and 6 in process, warm, 3 runs,
         each over all four formats,
         every row's count a numpy f64 oracle's (so the formats agree);
         soak at 3 x 300,000 points (every
         cell); memcheck at 64M points (every point collected and written,
         STREAMING OK, peak anonymous RSS); paperscale generate and oracle
         (in the background worker) and run at 4 x 64M LAST points (all
         four checks); the kernel check
         counts the in-process steps and the --profile worker's launches;
     every kernel of a path must have launched in it (in the distributed
     path, one of each named pair: which one runs depends on the transport)

It prints the nvidia-smi line and a JSON object of per-kernel numbers on the
lines before the last, and {"ok": true, "device": {...}} as the last line.

    python3 chip_smoke.py --distributed-only

runs the distributed path alone (the kernels built, no other phase) over a
smaller LAST dataset, 8 files x 2M points: on a machine of several cards
it takes the branches that one card never takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import hashlib
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from adhoc_queries_pointclouds_torch import _build, cli, engine, experiments, index, native
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.formats.las import (
    encode_point_records, make_writeback_header, parse_las_header_file,
)
from adhoc_queries_pointclouds_torch.host import packed_row_width
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.ops import compact as C
from adhoc_queries_pointclouds_torch.ops import density as D
from adhoc_queries_pointclouds_torch.ops import predicate as P
from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset
from adhoc_queries_pointclouds_torch.tools import (
    bboxprobe, density_bench, dist2, memcheck, packed_bench, paperscale, soak,
)
from adhoc_queries_pointclouds_torch.tools.kernel_timer import KernelTimer
from adhoc_queries_pointclouds_torch.utils.aabb import AABB, parse_aabb

SEED = 20261016
K, B = 4, 1 << 21  # AQPC_BLOCKS_PER_STEP blocks of DEFAULT_BLOCK_SIZE points
K_RESIDENT = 64  # blocks of a resident dataset in one launch: 134 M points
PACKED_WIDTHS = (0, 4, 12, 20, 28, 32)
# further width triples of the two packed bbox kernels: bit planes only, a
# full set of bit planes, byte planes only, 1 to 3 byte planes with bit
# planes on top, and the widest unsigned width
BBOX_PACKED_WIDTHS = [(1, 1, 1), (7, 7, 7), (8, 8, 8), (9, 17, 25), (31, 31, 31)]
# width pairs (k_hi, k_lo) of the two packed time kernels beyond (w, w):
# the e2e datasets' (20, 32), lo with bit planes under hi's byte planes,
# bit planes only, the widest unsigned pair, and either column at 0 or 32
TIME_PACKED_WIDTHS = [(w, w) for w in PACKED_WIDTHS] + [
    (20, 32), (4, 28), (1, 1), (7, 7), (31, 31), (3, 17), (32, 4), (0, 32), (8, 16), (4, 12),
    (12, 28)]
# block sizes of the packed bbox kernels' narrow path: B % 8 == 0 but
# B % 128 != 0, and B % 8 == 3 (byte planes only; the mask kernel's partial
# last word)
B_NARROW, B_BYTES_ONLY = B - 8, B - 8192 + 3
# published peaks of one H100 SXM: device memory, and float32 outside the
# tensor cores (integer compares and logic run no faster than that)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
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
# one second of flight over the LAST files 1-2 boundary (200,000 points):
# the resident time collect
E2E_TIME_COLLECT = (79.5, 80.5)
RESIDENT_REPEAT = 20  # --repeat of the resident counts
FORMATS = ("las", "last", "lazer", "laz")
DENSITIES = (0.0, 0.001, 0.5, 1.0)  # hit share of block k in the collect cases
# the hit shares at which the packed mask kernels are timed: a range on every
# block, since an empty range skips its block's planes
BUSY_DENSITIES = (0.25, 0.001, 0.5, 1.0)
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
    "compact_bits_gather": ("compact_bits.cu", _TPU + "ops/density.py:598"),
    "density_leaders": ("density.cu", _TPU + "ops/density.py:339"),
    "density_leaders_packed": ("density.cu", _TPU + "ops/density.py:339"),
    "density_candidates": ("density.cu", _TPU + "ops/density.py:339"),
    "density_candidates_packed": ("density.cu", _TPU + "ops/density.py:339"),
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


def check_no_jax(when: str) -> None:
    """The port and this script load no jax and nothing of the JAX package."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "adhoc_queries_pointclouds_tpu"))
    if loaded:
        fail(f"{when}: sys.modules holds {loaded}")
    print(f"{when}: no jax, no jaxlib and no module of the JAX package in sys.modules")


def phase_env() -> str:
    check_no_jax("after the port's imports")
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
    """The kernel library (nvcc, one process a source, all at once) and the
    host codec (g++) built together; then ptxas's registers and spills,
    from the library's own build log, of the tile-loop kernels: the packed
    bbox pair (one body a load kind), the packed time pair (a body for each
    pair of byte-plane counts and load kind: the e2e widths' body, (20, 32),
    the range of registers over all 25 and every body that spills), the raw
    time and class masks and the raw class count (one body a load kind)
    and the dictionary mask and count (a body for each load kind and
    byte-plane count); and the compaction."""
    codec = {}

    def build_codec():
        t0 = time.perf_counter()
        codec["lib"], codec["s"] = native.load(), time.perf_counter() - t0

    codec_thread = threading.Thread(target=build_codec)
    codec_thread.start()
    try:
        t0 = time.perf_counter()
        _build.library()
        print(f"built {_build.library_path()} in {time.perf_counter() - t0:.3f} s")
    finally:
        codec_thread.join()
    # the host codec (g++): the card's machine must not decode in Python
    if codec.get("lib") is None:
        fail("the port's native codec did not build or load (g++): formats would "
             "decode in Python")
    print(f"built {codec['lib']._name} in {codec['s']:.3f} s")
    log = _build.build_log_path()
    if not log.exists():
        fail(f"no nvcc log beside the kernel library ({log}): no ptxas report")
    bodies = ptxas_bodies(log.read_text())
    for (name, loads), shapes in sorted(bodies.items()):
        if None in shapes:
            print(f"ptxas {name}<{loads} loads>: {shapes[None]}")
        elif (4, 2) in shapes:
            spilling = {sh: f["spills"] for sh, f in sorted(shapes.items()) if f["spills"]}
            print(f"ptxas {name}<{loads} loads>: (20, 32) body {shapes[(4, 2)]}; {len(shapes)} "
                  f"bodies, {min(f['registers'] for f in shapes.values())}-"
                  f"{max(f['registers'] for f in shapes.values())} registers, spill bytes by "
                  f"(lo, hi) byte planes: {spilling or 'none'}")
        else:  # the dictionary bodies: (byte planes,) or (byte planes, bit planes)
            print(f"ptxas {name}<{loads} loads>: " + "; ".join(
                f"{sh[0]} byte planes{f', {sh[1]} bit planes' if len(sh) > 1 else ''} {f}"
                for sh, f in sorted(shapes.items())))


TILES_KERNELS = {"BoxTiles": "mask_bbox_packed", "TimeTiles": "mask_time_packed",
                 "DictTiles": "mask_class_dict", "TimeRawTiles": "mask_time",
                 "ClassRawTiles": "mask_class"}


def ptxas_bodies(text: str) -> dict:
    """{(kernel, loads): {byte planes ((lo, hi) for the packed time pair),
    or None: facts}} of the tile-loop kernels and the compaction (loads
    "any") in `nvcc -Xptxas -v` output."""
    entry = re.compile(r"(bbox_count_packed_kernel|time_count_packed_kernel|mask_packed_kernel"
                       r"|class_count_kernel|class_count_dict_kernel)I"
                       r"(?:N(?:4aqpc|S_)\d+(\w+?Tiles)I)?Lb([01])E((?:Li\d+E)*)"
                       r"|(compact_bits(?:_gather)?_kernel)")
    out: dict = {}
    lines = text.splitlines()
    for n, line in enumerate(lines):
        m = entry.search(line)
        if "Compiling entry function" not in line or not m:
            continue
        kernel, tiles, wide, planes, compact = m.groups()
        name = (kernel or compact).replace("_kernel", "")
        if name == "mask_packed":
            name = TILES_KERNELS[tiles]
        facts = " ".join(lines[n + 1:n + 4])
        regs = re.search(r"Used (\d+) registers", facts)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", facts)
        smem = re.search(r"(\d+) bytes smem", facts)
        shape = tuple(int(v) for v in re.findall(r"Li(\d+)E", planes or "")) or None
        loads = "any" if compact else "wide" if wide == "1" else "narrow"
        out.setdefault((name, loads), {})[shape] = {
            "registers": int(regs.group(1)) if regs else None,
            "spills": int(spills.group(1)) + int(spills.group(2)) if spills else None,
            "smem": int(smem.group(1)) if smem else 0}
    return out


# ---------------------------------------------------------------- phase 3


def rand_i32(gen, shape, dev, lo=I32_MIN, hi=I32_MAX) -> torch.Tensor:
    """Uniform int32 in [lo, hi], made on the card."""
    span = hi - lo + 1
    v = torch.randint(0, span, shape, dtype=torch.int64, device=dev, generator=gen)
    return (v + lo).to(torch.int32)


def rand_planes(gen, dev, widths, block_size: int) -> list:
    """One random (K, row width) u8 plane stack per width."""
    return [torch.randint(0, 256, (K, packed_row_width(w, block_size)), dtype=torch.uint8,
                          device=dev, generator=gen) for w in widths]


def edge_planes(gen, dev, widths, block_size: int) -> list:
    """Plane stacks in which about half of the residuals sit at the ends and
    the middle of residual space (bot, bot + 1, mid - 1, mid, top - 1, top),
    where the bounds of edge_bounds lie, and the rest anywhere in it."""
    stacks = []
    for w in widths:
        top, bot = ((1 << w) - 1, 0) if w < 32 else (I32_MAX, I32_MIN)
        mid = (top + bot) // 2
        palette = torch.tensor([bot, min(bot + 1, top), max(mid - 1, bot), mid, max(top - 1, bot),
                                top], dtype=torch.int64, device=dev)
        shape = (K, block_size)
        pick = torch.randint(0, len(palette), shape, device=dev, generator=gen)
        anywhere = torch.randint(bot, top + 1, shape, dtype=torch.int64, device=dev, generator=gen)
        r = torch.where(torch.rand(shape, device=dev, generator=gen) < 0.5, palette[pick], anywhere)
        u = r & 0xFFFFFFFF  # two's complement at w = 32
        parts = [((u >> (8 * p)) & 0xFF).to(torch.uint8) for p in range(w // 8)]
        weights = 1 << torch.arange(8, dtype=torch.int64, device=dev)
        for q in range(w % 8):  # little bit order, 8 points a byte
            bit = (u >> (8 * (w // 8) + q)) & 1
            parts.append((bit.view(K, block_size // 8, 8) * weights).sum(-1).to(torch.uint8))
        stacks.append(torch.cat(parts, 1) if parts
                      else torch.empty((K, 0), dtype=torch.uint8, device=dev))
    return stacks


def edge_bounds(widths, dev):
    """Residual-space (K, 3) los/his at and beyond both ends of each axis's
    residual space [bot, top] = [0, 2^w - 1] ([INT32_MIN, INT32_MAX] at
    w = 32), as the engine's saturating clip of a far box makes them: whole
    int32 range, exactly the space, one past each end, single values at each
    end, ranges wholly above or below the space, hi < lo. Yields (label,
    los, his): for each of three sets of four such ranges, once with every
    axis on the set (rotated, so that the rows differ between axes) and once
    with one axis on it and the others taking every residual."""
    def clip(v):
        return min(max(v, I32_MIN), I32_MAX)

    sets = []
    for w in widths:
        top, bot = ((1 << w) - 1, 0) if w < 32 else (I32_MAX, I32_MIN)
        mid = (top + bot) // 2
        sets.append([
            [(I32_MIN, I32_MAX), (bot, top), (clip(bot - 1), clip(top + 1)), (top, top)],
            [(bot, bot), (clip(top + 1), I32_MAX), (I32_MIN, clip(bot - 1)), (mid, mid - 1)],
            [(clip(bot + 1), clip(top - 1)), (I32_MAX, I32_MAX), (I32_MIN, I32_MIN), (-5, mid)],
        ])
    everything = (I32_MIN, I32_MAX)
    for s in range(3):
        for label, rows in (
            (f"edge set {s} on every axis",
             [[sets[a][s][(k + a) % 4] for a in range(3)] for k in range(K)]),
            (f"edge set {s} on axis {s}",
             [[sets[a][s][k] if a == s else everything for a in range(3)] for k in range(K)]),
        ):
            lo = torch.tensor([[r[0] for r in row] for row in rows], dtype=torch.int32, device=dev)
            hi = torch.tensor([[r[1] for r in row] for row in rows], dtype=torch.int32, device=dev)
            yield label, lo, hi


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


def packed_ops(k: int) -> float:
    """Integer operations per point that a range test on a k-bit bit-planar
    column needs at least, as csrc/bbox_planes.cuh does it: 2.5 per byte
    plane, 1/16 per bit plane, and 3 to turn byte flags into point bits (1.5
    with no bit plane on top)."""
    nbytes, nbits = k // 8, k % 8
    gather = 0 if nbytes == 0 else (1.5 if nbits == 0 else 3)
    return 2.5 * nbytes + gather + nbits / 16


def time_packed_ops(widths) -> float:
    """Integer operations per point of the packed time test as
    csrc/time_planes.cuh does it: 2.5 per byte plane and 1/16 per bit plane
    of both columns, 3 for a gather of both chains into point words (1.5
    for one gather of the two ANDed, when no bit plane follows), 2 for the
    spread back to per-byte borrows between lo's bit planes and hi's byte
    planes."""
    kh, kl = widths
    (hb, hq), (lb, lq) = divmod(kh, 8), divmod(kl, 8)
    ops = 2.5 * (hb + lb) + (hq + lq) / 16
    if lq:
        ops += (3 if lb else 0) + (2 if hb else 0)
    if hb or (lb and not lq):  # the chains end a byte plane
        ops += 3 if hq else 1.5
    return ops


def edge_queries(widths, dev):
    """Residual-space (K, 4) time queries at and beyond both ends of each
    column's residual space [bot, top] = [0, 2^k - 1] ([INT32_MIN,
    INT32_MAX] at k = 32): the whole int32 range, exactly the space, start ==
    end, equal hi words with lo at and beyond each end, ranges wholly above
    or below the space, the top and the bottom value alone, a lo word that
    carries into hi, and 2^k - 1, 2^k as query words; then rows of words
    drawn from those edges. Yields (label, qs)."""
    def clip(v):
        return min(max(v, I32_MIN), I32_MAX)

    ends = []
    for k in widths:
        top, bot = ((1 << k) - 1, 0) if k < 32 else (I32_MAX, I32_MIN)
        ends.append((bot, top, (top + bot) // 2, (1 << min(k, 31))))
    (bh, th, mh, ph), (bl, tl, ml, pl) = ends
    rows = [
        (I32_MIN, I32_MIN, I32_MAX, I32_MAX), (bh, bl, th, tl), (mh, ml, mh, ml),
        (mh, bl, mh, tl), (mh, I32_MIN, mh, I32_MAX), (clip(th + 1), I32_MIN, I32_MAX, I32_MAX),
        (I32_MIN, I32_MIN, clip(bh - 1), I32_MAX), (th, tl, I32_MAX, I32_MAX),
        (bh, bl, bh, clip(bl + 1)), (mh, clip(tl + 1), clip(mh + 1), 0), (-1, I32_MAX, 0, 1),
        (clip(ph - 1), clip(pl), clip(ph), -1),
    ]
    palette = [sorted({I32_MIN, I32_MAX, -1, 0, b, t, m, clip(t + 1), clip(p - 1), clip(p)})
               for b, t, m, p in ends]
    rng = np.random.default_rng(sum(widths))
    rows += [tuple(int(rng.choice(palette[a % 2])) for a in range(4)) for _ in range(2 * K)]
    for s in range(0, len(rows), K):
        yield f"edge rows {s}-{s + K - 1}", torch.tensor(rows[s:s + K], dtype=torch.int32,
                                                         device=dev)


def timed(timer, kernel_fn, plain_fn, nbytes: float, ops: float, indent: str = "  ",
          what: str = f"{K} full blocks", floor: dict | None = None,
          library_fn=None) -> dict:
    """Kernel and plain times at the main path's shape beside the bound: the
    larger of nbytes (every input read once, every output written once) at
    the card's memory rate and ops at its operation rate. ms and plain_ms
    are the calls' times (the host's enqueue inside the window), device_ms
    the kernel call's device work only (kernel_timer.py), each the median of
    TIMED_RUNS, the least printed beside the kernel's; floor, the times of
    the same loop with no planes, beside them. library_fn is one
    PyTorch call that computes the same function, where one exists (only
    compact_bits has one: torch.nonzero); library_ms is its call time, else
    None."""
    ms, least = timer.times(kernel_fn)
    device_ms, device_least = timer.times(kernel_fn, device=True)
    plain_ms, _ = timer.times(plain_fn)
    library_ms = None if library_fn is None else timer.times(library_fn)[0]
    library = "" if library_ms is None else f", library call {library_ms:.4f} ms"
    bound_ms, bound_by = bound_of(nbytes, ops)
    floor_text = "" if not floor else (f", floor (no planes) {floor['ms']:.4f} ms, device "
                                       f"{floor['device_ms']:.4f}")
    print(f"{indent}time, {what}: kernel {ms:.4f} ms (least {least:.4f}; device "
          f"{device_ms:.4f}, least {device_least:.4f}; {nbytes / device_ms / 1e6:.1f} GB/s)"
          f"{floor_text}, {nbytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms by {bound_by} "
          f"({100 * bound_ms / device_ms:.0f} % of the kernel's device time), "
          f"plain {plain_ms:.4f} ms{library}")
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def floor_breakdown(name: str, fn, device_ms: float, runs: int = 20) -> None:
    """Where one call's device time goes: torch.profiler's kernels of runs
    calls (each after an L2 flush by a kernel of another name), per call,
    and the gap between them and the timer's device reading, device_ms."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us and "bitwise_not" not in e.key:
            label = "counts memset (fill)" if "Fill" in e.key else e.key[:60]
            kernels[label] = kernels.get(label, 0.0) + us / runs / 1e3  # keys cut alike add up
    if not kernels:
        print(f"    {name}, one call's device time by kernel: not measured (no device time in "
              f"the profiler's trace)")
        return
    parts = ", ".join(f"{k} {v:.4f} ms" for k, v in kernels.items())
    gap = device_ms - sum(kernels.values())
    print(f"    {name}, one call's device time by kernel (torch.profiler, mean of {runs}): "
          f"{parts}; gap to the timer's {device_ms:.4f} ms: {gap:.4f}")


def bound_of(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for nbytes at the card's memory rate and ops at its
    operation rate, in ms, and which of the two it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = KernelTimer(dev, TIMED_RUNS)
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
    t = timed(timer, lambda: P.bbox_count_multi_kernel(*args),
              lambda: P.bbox_count_multi(*args), 12 * K * B, 12 * K * B)
    out["bbox_count_multi"] = dict(max_abs_err=max(errs), **t)

    # kernel 2: bbox_count_packed over bit-planar residual planes
    errs = []
    print(f"bbox_count_packed, K={K}, B={B}:")
    nvs = torch.tensor([B, B - 5, 777, 0], **i32)  # the last row is padding
    nv_mixed = torch.tensor([B, B - 5, 777, 1], **i32)
    nv_narrow = torch.tensor([B_NARROW, B_NARROW - 1, 4097, 1], **i32)
    nv_odd = torch.tensor([B_BYTES_ONLY, B_BYTES_ONLY - 1, 4097, 1], **i32)
    times = {}
    for widths in [(w, w, w) for w in PACKED_WIDTHS] + [(12, 20, 28)] + BBOX_PACKED_WIDTHS:
        planes = rand_planes(gen, dev, widths, B)
        # residual-space bounds: per-block boxes inside [0, 2^w) (any int32
        # at w = 32), as per-block bases give them; padding lo 0, hi -1
        tops = [(1 << w) - 1 if w < 32 else I32_MAX for w in widths]
        bots = [0 if w < 32 else I32_MIN for w in widths]
        a = torch.stack([rand_i32(gen, (K,), dev, b, t) for b, t in zip(bots, tops)], 1)
        c = torch.stack([rand_i32(gen, (K,), dev, b, t) for b, t in zip(bots, tops)], 1)
        box_lo, box_hi = torch.minimum(a, c), torch.maximum(a, c)
        lo, hi = box_lo.clone(), box_hi.clone()
        lo[-1], hi[-1] = 0, -1
        args = (*planes, lo, hi, nvs, widths, B)
        compare(f"widths {widths}", lambda: P.bbox_count_packed_kernel(*args),
                lambda: P.bbox_count_packed_multi(*args), errs)
        # bounds at and beyond both ends of residual space, wide loads and
        # (B % 128 != 0) the narrow path
        wide = edge_planes(gen, dev, widths, B)
        narrow = edge_planes(gen, dev, widths, B_NARROW)
        for label, elo, ehi in edge_bounds(widths, dev):
            args = (*wide, elo, ehi, nv_mixed, widths, B)
            compare(f"widths {widths}, {label}", lambda: P.bbox_count_packed_kernel(*args),
                    lambda: P.bbox_count_packed_multi(*args), errs)
            args = (*narrow, elo, ehi, nv_narrow, widths, B_NARROW)
            compare(f"widths {widths}, {label}, B={B_NARROW}",
                    lambda: P.bbox_count_packed_kernel(*args),
                    lambda: P.bbox_count_packed_multi(*args), errs)
        del wide, narrow
        if all(w % 8 == 0 for w in widths):  # byte planes only: any B
            odd = edge_planes(gen, dev, widths, B_BYTES_ONLY)
            for label, elo, ehi in edge_bounds(widths, dev):
                args = (*odd, elo, ehi, nv_odd, widths, B_BYTES_ONLY)
                compare(f"widths {widths}, {label}, B={B_BYTES_ONLY}",
                        lambda: P.bbox_count_packed_kernel(*args),
                        lambda: P.bbox_count_packed_multi(*args), errs)
            del odd
        # timed as the main path runs it: K full blocks, each with its box
        # (an empty box, as on a padding row, skips its block's planes)
        args = (*planes, box_lo, box_hi, nv_full, widths, B)
        nbytes = sum(widths) / 8 * K * B + 32 * K
        ops = sum(packed_ops(w) for w in widths) * K * B
        times[widths] = timed(timer, lambda: P.bbox_count_packed_kernel(*args),
                              lambda: P.bbox_count_packed_multi(*args), nbytes, ops, "    ",
                              floor=times.get((0, 0, 0)))
    # (20, 20, 20): the widths of the e2e datasets' blocks
    out["bbox_count_packed"] = dict(max_abs_err=max(errs), **times[(20, 20, 20)])
    kernels_class(dev, gen, timer, out)
    kernels_time(dev, gen, timer, out)
    kernels_collect(dev, gen, timer, out)
    kernels_density(dev, gen, timer, out)
    kernels_gather(dev, gen, timer, out)
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
            timed(timer, lambda: P.class_count(cls[1], targets[1], nv_full[1]),
                  lambda: plain(cls[1:2], targets[1:2], nv_full[1:2]), B, 2 * B,
                  what="K=1 (class_count), one full block")
        else:
            compare("K=1 (class_count_packed)",
                    lambda: P.class_count_packed(words[2], targets[2], nv_cases[0][1][2]).reshape(1),
                    lambda: plain(words[2:3], targets[2:3], nv_cases[0][1][2:3]), errs)
            timed(timer, lambda: P.class_count_packed(words[2], targets[2], nv_full[2]),
                  lambda: plain(words[2:3], targets[2:3], nv_full[2:3]), B, 2 * B,
                  what="K=1 (class_count_packed), one full block")
        t = timed(timer, lambda: kernel(col, targets, nv_full),
                  lambda: plain(col, targets, nv_full), K * B, 2 * K * B)
        out[name] = dict(max_abs_err=max(errs), **t)
        floor_breakdown(name, lambda: kernel(col, targets, nv_full), t["device_ms"])

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
        # timed on a code every block holds (a miss reads nothing)
        present = torch.tensor([j % (1 << k) for j in range(K)], **i32)
        compare(f"k={k}, target codes {present.tolist()}, n_valid B",
                lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B),
                lambda: P.class_count_dict_multi(cp, present, nv_full, k, B), errs)
        times[k] = timed(timer, lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B),
                         lambda: P.class_count_dict_multi(cp, present, nv_full, k, B),
                         k / 8 * K * B, (packed_ops(k) + 1) * K * B, "    ")
        if k == 2:  # blocks of the e2e datasets hold at most 4 classes
            floor_breakdown("class_count_dict, k = 2",
                            lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B),
                            times[k]["device_ms"])
    out["class_count_dict"] = dict(max_abs_err=max(errs), **times[2])
    del cls, words, hit, cp
    class_counts_resident(dev, gen, timer, out)


def class_counts_resident(dev, gen, timer, out) -> None:
    """The u8 and dictionary class counts at a resident dataset's K:
    K_RESIDENT blocks of 2^21 points (134 M points) in one launch, a target
    or present code in every block, against their plain versions; and the
    timer's own floor: one empty kernel (a spin of 0 cycles) and nothing
    at all between the events, in both readings."""
    i32 = dict(dtype=torch.int32, device=dev)
    nv_full = torch.full((K_RESIDENT,), B, **i32)
    targets = torch.tensor([6, 0, 255, 77] * (K_RESIDENT // 4), **i32)
    cls = torch.randint(0, 256, (K_RESIDENT, B), dtype=torch.uint8, device=dev, generator=gen)
    print(f"class_count_multi, K={K_RESIDENT}, B={B}:")
    errs: list[int] = []
    compare("n_valid B", lambda: P.class_count_multi_kernel(cls, targets, nv_full),
            lambda: P.class_count_multi(cls, targets, nv_full), errs)
    t = timed(timer, lambda: P.class_count_multi_kernel(cls, targets, nv_full),
              lambda: P.class_count_multi(cls, targets, nv_full), K_RESIDENT * B,
              2 * K_RESIDENT * B, what=f"{K_RESIDENT} full blocks")
    floor_breakdown(f"class_count_multi, K={K_RESIDENT}",
                    lambda: P.class_count_multi_kernel(cls, targets, nv_full), t["device_ms"])
    out["class_count_multi"]["max_abs_err"] = max(out["class_count_multi"]["max_abs_err"], *errs)
    del cls
    k = 2
    cp = torch.randint(0, 256, (K_RESIDENT, packed_row_width(k, B)), dtype=torch.uint8,
                       device=dev, generator=gen)
    present = torch.tensor([j % (1 << k) for j in range(K_RESIDENT)], **i32)
    print(f"class_count_dict, k = {k}, K={K_RESIDENT}, B={B}:")
    errs = []
    compare("target codes 0..3 in turn, n_valid B",
            lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B),
            lambda: P.class_count_dict_multi(cp, present, nv_full, k, B), errs)
    t = timed(timer, lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B),
              lambda: P.class_count_dict_multi(cp, present, nv_full, k, B),
              k / 8 * K_RESIDENT * B, (packed_ops(k) + 1) * K_RESIDENT * B,
              what=f"{K_RESIDENT} full blocks")
    floor_breakdown(f"class_count_dict, k = {k}, K={K_RESIDENT}",
                    lambda: P.class_count_dict_kernel(cp, present, nv_full, k, B), t["device_ms"])
    out["class_count_dict"]["max_abs_err"] = max(out["class_count_dict"]["max_abs_err"], *errs)
    del cp
    for what, fn in (("one empty kernel", lambda: torch.cuda._sleep(0)),
                     ("no work between the events", lambda: None)):
        ms, least = timer.times(fn)
        device_ms, device_least = timer.times(fn, device=True)
        print(f"timer floor, {what}: call {ms:.4f} ms (least {least:.4f}), device "
              f"{device_ms:.4f} ms (least {device_least:.4f})")


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
    t = timed(timer, lambda: P.time_count_multi_kernel(ths, tls, q_rand, nv_full),
              lambda: P.time_count_multi(ths, tls, q_rand, nv_full), 8 * K * B, 10 * K * B)
    out["time_count_multi"] = dict(max_abs_err=max(errs), **t)

    errs = []
    print(f"time_count_packed, K={K}, B={B}:")
    nvs = torch.tensor([B, B - 5, 777, 0], **i32)  # the last row is padding
    nv_mixed = torch.tensor([B, B - 5, 777, 1], **i32)
    nv_narrow = torch.tensor([B_NARROW, B_NARROW - 1, 4097, 1], **i32)
    nv_odd = torch.tensor([B_BYTES_ONLY, B_BYTES_ONLY - 1, 4097, 1], **i32)
    times = {}
    for widths in TIME_PACKED_WIDTHS:
        planes = rand_planes(gen, dev, widths, B)
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
        # queries at and beyond both ends of residual space, wide loads, the
        # narrow path (B % 128 != 0) and, byte planes only, any B
        sizes = [(B, nv_mixed), (B_NARROW, nv_narrow)]
        if all(w % 8 == 0 for w in widths):
            sizes.append((B_BYTES_ONLY, nv_odd))
        for bs, nv in sizes:
            edge = edge_planes(gen, dev, widths, bs)
            for label, eq in edge_queries(widths, dev):
                args = (*edge, eq, nv, widths, bs)
                compare(f"widths {widths}, {label}, B={bs}",
                        lambda: P.time_count_packed_kernel(*args),
                        lambda: P.time_count_packed_multi(*args), errs)
            del edge
        times[widths] = timed(
            timer, lambda: P.time_count_packed_kernel(*planes, qs, nv_full, widths, B),
            lambda: P.time_count_packed_multi(*planes, qs, nv_full, widths, B),
            sum(widths) / 8 * K * B, time_packed_ops(widths) * K * B, "    ",
            floor=times.get((0, 0)))
    # (20, 32): about the widths of the e2e datasets' blocks
    out["time_count_packed"] = dict(max_abs_err=max(errs), **times[(20, 32)])


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


def compare_mask(name, kernel_fn, plain_fn, errs) -> None:
    """One bit-mask entry against its plain version: words, counts and chunk
    counts, with no compaction."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    torch.cuda.synchronize()
    same_shape = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if w.numel() else 0
              for g, w in zip(got, want))
    errs.append(err)
    print(f"  {name}: counts kernel {got.counts.tolist()} plain {want.counts.tolist()}; "
          f"max_abs_err mask {err}")
    if not same_shape or err:
        fail(f"{name}: kernel disagrees with its plain version")


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
    bu = B_BYTES_ONLY  # B % 8 == 3: byte planes only, rows unaligned
    nv_u = torch.tensor([bu, bu - 1, 4097, 0], **i32)
    compact_errs: list[int] = []
    hit = hit_rows(gen, dev, B)
    want = hit.sum(1).tolist()

    def raw_kind(name, args, kernel, plain, nbytes, ops):
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
        t = timed(timer, lambda: kernel(*full), lambda: P.pack_mask_bits(plain(*full)),
                  nbytes * K * B + K * B / 8, ops * K * B)
        out[name] = dict(max_abs_err=max(errs["mask"]), **t)
        return mask, off, total

    # raw bbox: rows hit by construction, y and z always inside
    inside = dict(lo=-(2**29), hi=2**29)
    xs = torch.where(hit, rand_i32(gen, (K, B), dev, **inside),
                     rand_i32(gen, (K, B), dev, 2**29 + 1, I32_MAX))
    ys, zs = (rand_i32(gen, (K, B), dev, **inside) for _ in range(2))
    lo = torch.full((K, 3), -(2**29), **i32)
    hi = torch.full((K, 3), 2**29, **i32)
    mask, off, total = raw_kind("mask_bbox", lambda nv: (xs, ys, zs, lo, hi, nv),
                                P.bbox_mask_bits, P.bbox_mask_multi, 12, 12)
    print(f"compact_bits, blocks at densities {DENSITIES[1:3]} (the partial ones):")
    # operations: a popc and a scan step per mask word, a few per hit; the
    # library call: torch.nonzero on the partial blocks' bool rows (as the
    # JAX package's jnp.nonzero per block), which reads a byte a row and
    # writes int64 (block, row) pairs
    partial = hit[1:3].contiguous()
    if not torch.equal(torch.nonzero(partial)[:, 1].to(torch.int32),
                       C.compact_bits(mask.bits, mask.chunks, off, total, B)):
        fail("compact_bits: the hit rows differ from torch.nonzero's")
    compact_times = timed(
        timer, lambda: C.compact_bits(mask.bits, mask.chunks, off, total, B),
        lambda: C.compact_bits_plain(mask.bits, mask.chunks, off, total, B),
        2 * B / 8 + 4 * total, 2 * B / 32 * 8 + 4 * total, what=f"{total} hits of 2 blocks",
        library_fn=lambda: torch.nonzero(partial))
    del xs, ys, zs

    cls = torch.where(hit, 6, torch.randint(7, 256, (K, B), device=dev, generator=gen))
    cls = cls.to(torch.uint8)
    targets = torch.full((K,), 6, **i32)
    raw_kind("mask_class", lambda nv: (cls, targets, nv), P.class_mask_bits, P.class_mask_multi, 1, 2)
    # targets at and beyond both ends of a byte (outside 0..255 nothing
    # matches and nothing is read) over bytes that are mostly 0, 6 and 255,
    # on the 16-byte loads and on the byte loads (B % 16 != 0, rows off
    # 16-byte boundaries)
    palette = torch.tensor([0, 1, 6, 254, 255], dtype=torch.uint8, device=dev)
    ends = torch.where(torch.rand((K, B), device=dev, generator=gen) < 0.7,
                       palette[torch.randint(0, 5, (K, B), device=dev, generator=gen)], cls)
    nv_mixed = torch.tensor([B, B - 5, 777, 1], **i32)
    edge_errs = {"mask": [], "compact": compact_errs}
    for row in ([-1, 0, 255, 256], [I32_MAX, 6, 0, 255], [I32_MIN, 255, 6, 0]):
        tg = torch.tensor(row, **i32)
        compare_collect(f"mask_class, targets {row}",
                        lambda: P.class_mask_bits(ends, tg, nv_mixed),
                        lambda: P.pack_mask_bits(P.class_mask_multi(ends, tg, nv_mixed)),
                        nv_mixed, B, edge_errs)
        un = unaligned(ends, bu)
        compare_collect(f"mask_class, targets {row}, unaligned B={bu}",
                        lambda: P.class_mask_bits(un, tg, nv_u),
                        lambda: P.pack_mask_bits(P.class_mask_multi(un, tg, nv_u)), nv_u, bu,
                        edge_errs)
    out["mask_class"]["max_abs_err"] = max(out["mask_class"]["max_abs_err"], *edge_errs["mask"])
    del ends
    # the same function by way of the dictionary mask's body at k = 8 (a u8
    # row is one byte plane; box_axis clamps a target outside 0..255 to an
    # empty row), held and timed on the same bytes
    compare_mask("mask_class_dict at k = 8 on the class bytes",
                 lambda: P.class_mask_bits_dict(cls, targets, nv_full, 8, B),
                 lambda: P.pack_mask_bits(P.class_mask_multi(cls, targets, nv_full)), [])
    print("  the same bytes through DictTiles at k = 8:")
    timed(timer, lambda: P.class_mask_bits_dict(cls, targets, nv_full, 8, B),
          lambda: P.pack_mask_bits(P.class_mask_multi(cls, targets, nv_full)), K * B + K * B / 8,
          2 * K * B, "    ")
    class_call = (cls, targets, nv_full)

    # raw time: hit rows have hi word -1, the others hi >= 0 (the sign
    # boundary); q = [(-1, INT_MIN), (0, INT_MIN)) takes exactly hi == -1
    ths = torch.where(hit, -1, rand_i32(gen, (K, B), dev, 0, I32_MAX)).to(torch.int32)
    tls = rand_i32(gen, (K, B), dev)
    qs = torch.tensor([[-1, I32_MIN, 0, I32_MIN]] * K, **i32)
    raw_kind("mask_time", lambda nv: (ths, tls, qs, nv), P.time_mask_bits, P.time_mask_multi, 8, 10)
    floor_breakdown("mask_time", lambda: P.time_mask_bits(ths, tls, qs, nv_full),
                    out["mask_time"]["device_ms"])
    del ths, tls

    def packed_kind(name, label, make, kernel, plain, nbytes, ops, main_case, cases,
                    unaligned_case, more=None, floor_case=None, busy=None):
        """One packed mask entry over its cases; more(case) yields further
        (label, operands) held mask against mask; floor_case is the case
        with no planes, whose time is printed beside every later one;
        busy(case) the operands it is timed on, where the compare's full
        blocks skip some block (default: those)."""
        errs = {"mask": [], "compact": compact_errs}
        timed_at = f", timed at {BUSY_DENSITIES}" if busy else ""
        print(f"{name}, K={K}, B={B}, hit densities about {DENSITIES}{timed_at}:")
        times = {}
        for case in cases:
            full = make(case, B, nv_full)
            compare_collect(f"{label} {case}, n_valid B", lambda: kernel(*full),
                            lambda: P.pack_mask_bits(plain(*full)), nv_full, B, errs)
            edge = make(case, B, nv_edges)
            compare_collect(f"{label} {case}, n_valid 0, 1, B-1, B", lambda: kernel(*edge),
                            lambda: P.pack_mask_bits(plain(*edge)), nv_edges, B, errs)
            for what, args in more(case) if more else ():
                compare_mask(f"{label} {case}, {what}", lambda: kernel(*args),
                             lambda: P.pack_mask_bits(plain(*args)), errs["mask"])
            run = full
            if busy:
                run = busy(case)
                compare_mask(f"{label} {case}, timed at {BUSY_DENSITIES}", lambda: kernel(*run),
                             lambda: P.pack_mask_bits(plain(*run)), errs["mask"])
            times[case] = timed(timer, lambda: kernel(*run),
                                lambda: P.pack_mask_bits(plain(*run)),
                                (nbytes(case) + 1 / 8) * K * B, ops(case) * K * B, "    ",
                                floor=times.get(floor_case))
        un = make(unaligned_case, bu, nv_u)
        compare_collect(f"{label} {unaligned_case}, unaligned B={bu}", lambda: kernel(*un),
                        lambda: P.pack_mask_bits(plain(*un)), nv_u, bu, errs)
        out[name] = dict(max_abs_err=max(errs["mask"]), **times[main_case])

    def planes(w, block_size):
        return rand_planes(gen, dev, (w,), block_size)[0]

    def bbox_case(widths, block_size, nvs, densities=DENSITIES):
        # x holds the block's density, y and z take every residual
        rows = [[res_range(widths[0], d), res_range(widths[1], 1), res_range(widths[2], 1)]
                for d in densities]
        lo = torch.tensor([[a[0] for a in r] for r in rows], **i32)
        hi = torch.tensor([[a[1] for a in r] for r in rows], **i32)
        return (*(planes(w, block_size) for w in widths), lo, hi, nvs, widths, block_size)

    nv_narrow = torch.tensor([B_NARROW, B_NARROW - 1, 4097, 1], **i32)

    def bbox_edges(widths):
        # bounds at and beyond both ends of residual space, wide loads and
        # (B % 128 != 0) the narrow path
        wide = edge_planes(gen, dev, widths, B)
        narrow = edge_planes(gen, dev, widths, B_NARROW)
        for what, lo, hi in edge_bounds(widths, dev):
            yield what, (*wide, lo, hi, nv_mixed, widths, B)
            yield f"{what}, B={B_NARROW}", (*narrow, lo, hi, nv_narrow, widths, B_NARROW)
        if all(w % 8 == 0 for w in widths):  # byte planes only: any B
            odd = edge_planes(gen, dev, widths, bu)
            for what, lo, hi in edge_bounds(widths, dev):
                yield f"{what}, B={bu}", (*odd, lo, hi, nv_u, widths, bu)

    packed_kind("mask_bbox_packed", "widths", bbox_case, P.bbox_mask_bits_packed,
                P.bbox_mask_packed_multi, lambda w: sum(w) / 8,
                lambda w: sum(packed_ops(k) for k in w), (20, 20, 20),
                [(w, w, w) for w in PACKED_WIDTHS] + [(12, 20, 28)] + BBOX_PACKED_WIDTHS,
                (8, 16, 32), bbox_edges, (0, 0, 0),
                lambda w: bbox_case(w, B, nv_full, BUSY_DENSITIES))

    def time_case(widths, block_size, nvs, densities=DENSITIES):
        # the hi residual in [bot, bot + density * 2^k_hi); the lo residual
        # never decides (its lowest value bounds both ends)
        kh, kl = widths
        low = 0 if kl < 32 else I32_MIN
        rows = []
        for d in densities:
            if d == 0:
                rows.append([0, 0, 0, 0])  # start == end
            elif d == 1:
                rows.append([I32_MIN, I32_MIN, I32_MAX, I32_MAX])
            else:
                bot, top = res_range(kh, d)
                rows.append([bot, low, top + 1, low])
        qs = torch.tensor(rows, **i32)
        return (planes(kh, block_size), planes(kl, block_size), qs, nvs, widths, block_size)

    def time_edges(widths):
        # queries at and beyond both ends of residual space at the block
        # sizes of bbox_edges
        sizes = [(B, nv_mixed), (B_NARROW, nv_narrow)]
        if all(w % 8 == 0 for w in widths):
            sizes.append((bu, nv_u))
        for bs, nv in sizes:
            edge = edge_planes(gen, dev, widths, bs)
            for what, qs in edge_queries(widths, dev):
                yield f"{what}, B={bs}", (*edge, qs, nv, widths, bs)

    packed_kind("mask_time_packed", "widths", time_case, P.time_mask_bits_packed,
                P.time_mask_packed_multi, lambda w: sum(w) / 8, time_packed_ops, (20, 32),
                TIME_PACKED_WIDTHS, (16, 32), time_edges, (0, 0),
                lambda w: time_case(w, B, nv_full, BUSY_DENSITIES))

    def dict_case(k, block_size, nvs, codes=None):
        # codes: a miss (len(dict)), two codes at 2^-k, and a block of code 0
        cp = planes(k, block_size)
        cp[3] = 0
        if codes is None:
            codes = [1 << k, 0, 1 % (1 << k), 0]
        return (cp, torch.tensor(codes, **i32), nvs, k, block_size)

    # timed on a code in every block (a miss skips its block's planes); k = 0,
    # no planes and every code 0, is the floor printed beside the others
    packed_kind("mask_class_dict", "k", dict_case, P.class_mask_bits_dict,
                P.class_mask_dict_multi, lambda k: k / 8, lambda k: packed_ops(k) + 1, 2,
                [0, 1, 2, 4, 8], 8, floor_case=0,
                busy=lambda k: dict_case(k, B, nv_full, [j % (1 << k) for j in range(K)]))
    busy = dict_case(2, B, nv_full, [0, 1, 2, 3])
    floor_breakdown("mask_class_dict, k = 2", lambda: P.class_mask_bits_dict(*busy),
                    out["mask_class_dict"]["device_ms"])
    # the profiler's runs come after every timing of the collect kernels
    floor_breakdown("mask_class", lambda: P.class_mask_bits(*class_call),
                    out["mask_class"]["device_ms"])
    floor_breakdown("compact_bits", lambda: C.compact_bits(mask.bits, mask.chunks, off, total, B),
                    compact_times["device_ms"])
    del class_call

    out["compact_bits"] = dict(max_abs_err=max(compact_errs), **compact_times)


# The density kernels' data (tools/density_bench.py, whose timings these
# repeat): file-local coordinates at scale 0.001 over a grid of 2^20 x 2^20
# x 2^17 units (1048.576 x 1048.576 x 131.072 m), so that 20-, 20- and
# 17-bit residuals above base 0 cover it exactly; cells of 30, 10 and 4.1 m
# put about 340, 13 and one point in a cell at 2^21 points a block, and
# 0.05 m cells make a grid of over 2^32 cells (16-byte table slots).
DENSITY_BITS = density_bench.BITS
DENSITY_CELLS = density_bench.CELLS
DENSITY_FINE_CELL = 0.05


def compare_density(name, xyz, rows, nvs, tables, block_size, errs, packed=None,
                    want_all=False) -> int:
    """Both density kernels against their plain versions on one step, the
    table sized as the engine sizes it: the leaders (every occupied cell's
    key and least d2, bit for bit, through table_leaders), the candidates'
    BitMask (words, counts, chunk counts), and the indices the compaction
    makes of it, ascending. packed = (planes, bases, widths) takes the packed
    entries over the same points. want_all: every valid predicate hit must
    come out (flagged points survive wholesale). Returns the occupied cells
    of all blocks."""
    k_blocks = rows.shape[0]
    mask = P.pack_mask_bits(rows & P._valid(nvs, block_size, rows.device))
    cells = D.grid_cells(tables)
    slots = D.table_slots(int(mask.counts.max()), cells)
    if packed is None:
        points, kw = xyz, {}
    else:
        points, kw = packed[0], dict(bases=packed[1], widths=packed[2])
    table = D.density_leaders(points, mask.bits, nvs, tables, block_size, slots=slots, **kw)
    got = D.density_candidates(points, mask.bits, nvs, tables, table, block_size, **kw)
    torch.cuda.synchronize()
    want_leaders = D.density_leaders_plain(*xyz, rows, nvs, tables)
    want = P.pack_mask_bits(D.density_candidates_plain(*xyz, rows, nvs, tables))
    torch.cuda.synchronize()
    lead_err = 0
    for (gk, gv), (wk, wv) in zip(D.table_leaders(table, k_blocks, cells), want_leaders):
        same = gk.shape == wk.shape and torch.equal(gk, wk) and torch.equal(
            gv, wv.view(torch.int32))
        lead_err = max(lead_err, 0 if same else 1)
    same_shape = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    mask_err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if w.numel() else 0
                   for g, w in zip(got, want))
    counts = want.counts.tolist()
    offsets = [sum(counts[:j]) if c else -1 for j, c in enumerate(counts)]
    off = torch.tensor(offsets, dtype=torch.int64, device=rows.device)
    idx = C.compact_bits(got.bits, got.chunks, off, sum(counts), block_size)
    torch.cuda.synchronize()
    ref = torch.nonzero(P.unpack_mask_bits(want.bits, block_size))[:, 1].to(torch.int32)
    idx_err = int((idx.to(torch.int64) - ref.to(torch.int64)).abs().max()) if len(ref) else 0
    errs["leaders"].append(lead_err)
    errs["candidates"].append(mask_err)
    errs["compact"].append(idx_err)
    occupied = [len(k) for k, _ in want_leaders]
    hashed = "hashed" if cells > slots else "direct"
    print(f"  {name}: predicate hits {mask.counts.tolist()}, occupied cells {occupied}, "
          f"{slots} {hashed} slots of {D.slot_bytes(cells)} B a block, candidates kernel "
          f"{got.counts.tolist()} plain {counts}; max_abs_err leaders {lead_err}, "
          f"mask {mask_err}, indices {idx_err}")
    if not same_shape or lead_err or mask_err or idx_err or idx.shape != ref.shape:
        fail(f"{name}: a density kernel disagrees with its plain version")
    if want_all and counts != mask.counts.tolist():
        fail(f"{name}: {counts} candidates of {mask.counts.tolist()} flagged points")
    return sum(occupied)


def kernels_density(dev, gen, timer, out) -> None:
    """The density kernels (density.cu), raw and packed, against their
    plain versions; then every row a hit at each of the three grids, held
    against the plain versions and timed, the table sized as the engine
    sizes it and its clearing inside density_leaders' window."""
    i32 = dict(dtype=torch.int32, device=dev)
    nv_full = torch.full((K,), B, **i32)
    nv_edges = torch.tensor([0, 1, B - 1, B], **i32)
    bu = B_BYTES_ONLY
    nv_u = torch.tensor([bu, bu - 1, 4097, 0], **i32)
    errs = {"leaders": [], "candidates": [], "compact": []}
    hit = hit_rows(gen, dev, B)
    few = hit.clone()
    few[2:] = False  # blocks at densities 0 and 0.1 % only: a small, hashed table
    everything = torch.ones((K, B), dtype=torch.bool, device=dev)
    res = density_bench.residuals(gen, dev)
    # points beyond the max face, at the int32 extremes and below the grid,
    # and exact d2 ties around the centre of cell (0, 0, 0) of the 10 m grid
    special = torch.tensor([[1 << 20, 5, 5], [1048576 + 77, 9, 9], [I32_MAX, 5, 5],
                            [I32_MIN, 5, 5], [5, I32_MAX, 5], [5, 5, I32_MIN], [-3, -3, -3],
                            [5100, 5000, 5000], [4900, 5000, 5000], [5000, 5100, 5000],
                            [5000, 5000, 4900], [5000, 5000, 5101]], dtype=torch.int64, device=dev)
    xyz = [r.clone() for r in res]
    for a in range(3):
        xyz[a][:, 64 : 64 + len(special)] = special[:, a]
    xyz = [t.to(torch.int32) for t in xyz]
    tables = {name: density_bench.grid_tables(dev, cell) for name, cell in DENSITY_CELLS.items()}
    fine = density_bench.grid_tables(dev, DENSITY_FINE_CELL)

    print(f"density_leaders and density_candidates, K={K}, B={B}, hit densities {DENSITIES}:")
    for name, t in tables.items():
        compare_density(f"{name} grid, n_valid B", xyz, hit, nv_full, t, B, errs)
        compare_density(f"{name} grid, n_valid 0, 1, B-1, B", xyz, hit, nv_edges, t, B, errs)
        compare_density(f"{name} grid, hits in blocks 0 and 1 only", xyz, few, nv_full, t, B,
                        errs)
    compare_density(f"{DENSITY_FINE_CELL} m grid ({D.grid_cells(fine)} cells), n_valid B", xyz,
                    hit, nv_full, fine, B, errs)
    # ties: of the five points around the centre of cell (0, 0, 0), the four
    # at distance 100 tie exactly and survive; the one at 101 does not
    ties = torch.zeros((K, B), dtype=torch.bool, device=dev)
    ties[:, 71:76] = True
    got = D.density_candidates_bits(xyz, P.pack_mask_bits(ties), nv_full, tables["main"], B)
    if got.counts.tolist() != [4] * K:
        fail(f"exact d2 ties: {got.counts.tolist()} candidates a block, built with 4")
    uxyz = [unaligned(t, bu) for t in xyz]
    compare_density(f"main grid, unaligned B={bu}", uxyz, unaligned(hit, bu), nv_u,
                    tables["main"], bu, errs)
    # a degenerate axis (zero extent in z: dims 0): cell 0 of z holds every
    # point below the int32 maximum; and a grid every point lies beyond
    compare_density("degenerate z axis", xyz, hit, nv_full,
                    density_bench.grid_tables(dev, 10.0, 0.0), B, errs)
    far = [t + (1 << 22) for t in xyz[:1]] + xyz[1:]
    compare_density("every point beyond the max face", far, hit, nv_full, tables["main"], B, errs,
                    want_all=True)

    print(f"density_leaders_packed and density_candidates_packed, K={K}, B={B}:")
    perrs = {"leaders": [], "candidates": [], "compact": errs["compact"]}
    t_main = tables["main"]
    # the raw case's own points as (20, 20, 20) planes above base 0: the
    # widths of the end-to-end datasets' blocks
    zero = torch.zeros((K, 3), **i32)
    main_w = density_bench.PACKED_WIDTHS
    main_planes = [density_bench.planes_of(r, w) for r, w in zip(res, main_w)]
    main_xyz = [r.to(torch.int32) for r in res]
    compare_density(f"widths {main_w}, main grid", main_xyz, hit, nv_full, t_main, B, perrs,
                    packed=(main_planes, zero, main_w))
    compare_density(f"widths {main_w}, main grid, hits in blocks 0 and 1 only", main_xyz, few,
                    nv_full, t_main, B, perrs, packed=(main_planes, zero, main_w))
    compare_density(f"widths {main_w}, {DENSITY_FINE_CELL} m grid", main_xyz, hit, nv_full, fine,
                    B, perrs, packed=(main_planes, zero, main_w))
    for widths in [(w, w, w) for w in PACKED_WIDTHS] + [(12, 20, 28)]:
        planes = rand_planes(gen, dev, widths, B)
        # bases that centre each axis's residual range on the grid (0 at 32
        # bits, where the residual is the coordinate)
        bases = torch.tensor([[0 if w == 32 else (1 << (bits - 1)) - ((1 << w) >> 1)
                               for w, bits in zip(widths, DENSITY_BITS)]] * K, **i32)
        bases[1] += 1000
        pxyz = D.unpack_xyz(planes, bases, widths, B)
        for label, nvs in (("n_valid B", nv_full), ("n_valid 0, 1, B-1, B", nv_edges)):
            compare_density(f"widths {widths}, main grid, {label}", pxyz, hit, nvs, t_main, B,
                            perrs, packed=(planes, bases, widths))
    odd_w = (8, 16, 32)
    planes = rand_planes(gen, dev, odd_w, bu)
    bases = torch.tensor([[1 << 19, 1 << 19, 0]] * K, **i32)
    compare_density(f"widths {odd_w}, unaligned B={bu}", D.unpack_xyz(planes, bases, odd_w, bu),
                    unaligned(hit, bu), nv_u, t_main, bu, perrs, packed=(planes, bases, odd_w))

    # every row a hit, at each grid: held against the plain versions and
    # timed by tools/density_bench.py's grid_case, the plain versions timed
    # beside; the kernels line keeps the main grid's numbers
    packed = dict(bases=zero, widths=main_w)
    times = {}
    for name, t in tables.items():
        print(f"every row a hit, {name} grid ({DENSITY_CELLS[name]} m, {D.grid_cells(t)} cells), "
              f"K={K}, B={B}:")
        for suffix, points, kw, point_bytes in (("", main_xyz, {}, 12.0),
                                                ("_packed", main_planes, packed, sum(main_w) / 8)):
            # the plain versions on the same inputs: the planes unpacked first
            xyz_of = (lambda: D.unpack_xyz(main_planes, zero, main_w, B)) if kw else (
                lambda: main_xyz)
            plain = {
                "leaders": lambda: D.density_leaders_plain(*xyz_of(), everything, nv_full, t),
                "candidates": lambda: P.pack_mask_bits(
                    D.density_candidates_plain(*xyz_of(), everything, nv_full, t)),
            }
            plain_ms = {step: timer.times(fn)[0] for step, fn in plain.items()}
            row = density_bench.grid_case(D, P, timer, t, points, kw, main_xyz, everything,
                                          nv_full, point_bytes)
            print(f"  {'raw' if not kw else f'widths {main_w}'}, held: "
                  f"{row['occupied_cells']} occupied cells; {density_bench.describe(row)}; "
                  f"plain {plain_ms['leaders']:.4f} / {plain_ms['candidates']:.4f} ms")
            for step in ("leaders", "candidates"):
                times[name, f"density_{step}{suffix}"] = dict(
                    ms=row[f"{step}_ms"], device_ms=row[f"{step}_device_ms"],
                    plain_ms=plain_ms[step], bound_ms=row[f"{step}_bound_ms"],
                    bound_by=row[f"{step}_bound_by"], library_ms=None)
    for kernel in ("density_leaders", "density_candidates", "density_leaders_packed",
                   "density_candidates_packed"):
        e = perrs if kernel.endswith("_packed") else errs
        key = "leaders" if "leaders" in kernel else "candidates"
        out[kernel] = dict(max_abs_err=max(e[key] + e["compact"]), **times["main", kernel])


def kernels_gather(dev, gen, timer, out) -> None:
    """compact_bits_gather (compact_bits.cu) against its plain version on
    the edges of the resident density path's gather: every block skipped,
    blocks with 0 hits given an offset, full blocks (the density path gives
    them offsets), skipped blocks, a partial last mask word at a B that is
    no multiple of 8,192, K > 65,535, and the edges of its dense and sparse
    paths (tools/packed_bench.py gather_edges, as the card test holds
    them); then at the path's shape, K blocks of 2^21 rows at the hit
    shares DENSITIES, and at a share of 0.01 on every block (sparse), every
    block given an offset, timed (no PyTorch call computes the function: no
    library time). The bound counts the mask's bit a row, 16 bytes written
    a hit and the 32-byte sectors of x, y and z that the hits touch (the
    card reads a sector whole); the count of PRs 12-14, 12 bytes read a
    hit, is printed beside it."""
    errs: list[int] = []
    print("compact_bits_gather:")

    def case(label, rows, skip=()):
        k_blocks, block_size = rows.shape
        mask = P.pack_mask_bits(rows)
        offsets, total = [], 0
        for j, c in enumerate(mask.counts.tolist()):
            offsets.append(-1 if j in skip else total)
            total += 0 if j in skip else c
        off = torch.tensor(offsets, dtype=torch.int64, device=dev)
        xyz = [rand_i32(gen, (k_blocks, block_size), dev) for _ in range(3)]
        args = (mask.bits, mask.chunks, off, total, block_size, *xyz)
        got = C.compact_bits_gather(*args)
        torch.cuda.synchronize()
        want = C.compact_bits_gather_plain(*args)
        same = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if w.numel() else 0
                  for g, w in zip(got, want))
        errs.append(err)
        print(f"  {label}, K={k_blocks}, B={block_size}: {total} rows and their x, y, z from "
              f"{k_blocks - len(skip)} blocks; max_abs_err {err}")
        if not same or err:
            fail(f"compact_bits_gather, {label}: kernel disagrees with its plain version")
        return args, total

    def shares(k_blocks, block_size, values):
        dens = torch.tensor(values, device=dev).repeat(k_blocks // len(values) + 1)[:k_blocks]
        return torch.rand((k_blocks, block_size), device=dev, generator=gen) < dens[:, None]

    odd = 3 * 8192 + 40  # no multiple of 8,192, and a partial last word
    rows = shares(4, odd, DENSITIES)
    case("every block skipped", rows, skip=range(4))
    case("0 hits, 0.1 %, 1/2 and full blocks, all with offsets", rows)
    case("block 2 skipped", rows, skip=(2,))
    case("K > 65,535", shares(65548, 128, (0.0, 0.001, 0.3, 0.5, 0.9, 1.0, 0.05)))
    for label, edge, skip in packed_bench.gather_edges(SEED):
        case(label, torch.from_numpy(edge).to(dev), skip)
    timed_cases = [("the path's shape", hit_rows(gen, dev, B)),
                   ("sparse, a share of 0.01 on every block", shares(K, B, (0.01,)))]
    times = []
    for label, hit in timed_cases:
        args, total = case(label, hit)
        sectors = packed_bench.gather_sector_bytes(hit)
        hit_bound = bound_of(K * B / 8 + 12 * total + 16 * total, 0)[0]
        print(f"  bound by hits (PRs 12-14: 12 B read a hit) {hit_bound:.4f} ms; by sectors "
              f"{sectors / 1e6:.2f} MB of x, y, z read")
        t = timed(timer, lambda: C.compact_bits_gather(*args),
                  lambda: C.compact_bits_gather_plain(*args),
                  K * B / 8 + sectors + 16 * total, K * B / 32 * 8 + 4 * total,
                  what=f"{label}: {total} rows of {K} blocks")
        times.append(t)
    out["compact_bits_gather"] = dict(max_abs_err=max(errs), **times[0])  # the path's shape


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
    t = timed(timer, lambda: P.bbox_probe_acc_kernel(x, y, z, lo, hi, nvt),
              lambda: P.bbox_probe_acc(x, y, z, lo, hi, nvt), 12 * n, 12 * n,
              what=f"{n} points")
    out["bbox_probe_acc"] = dict(max_abs_err=max(errs), **t)
    errs = []
    print(f"bbox_probe_acc_nomask, n={n}:")
    compare("aligned", lambda: P.bbox_probe_acc_nomask_kernel(x, y, z, lo, hi).reshape(1),
            lambda: P.bbox_probe_acc_nomask(x, y, z, lo, hi).reshape(1), errs)
    compare("columns off 16-byte bounds",
            lambda: P.bbox_probe_acc_nomask_kernel(x[1:], y[1:], z[1:], lo, hi).reshape(1),
            lambda: P.bbox_probe_acc_nomask(x[1:], y[1:], z[1:], lo, hi).reshape(1), errs)
    t = timed(timer, lambda: P.bbox_probe_acc_nomask_kernel(x, y, z, lo, hi),
              lambda: P.bbox_probe_acc_nomask(x, y, z, lo, hi), 12 * n, 12 * n,
              what=f"{n} points")
    out["bbox_probe_acc_nomask"] = dict(max_abs_err=max(errs), **t)
    # (b), bbox_count_pallas: the K = 1 launch of bbox_count_multi, one
    # block of the probe's size
    errs = []
    print(f"bbox_count (the K=1 launch of bbox_count_multi), one block of {n}:")
    nvt = torch.tensor(n, **i32)
    one = (x[None], y[None], z[None], lo[None], hi[None], nvt.reshape(1))
    for label, nv in (("n_valid n", n), ("n_valid n - 5", n - 5)):
        nvt = torch.tensor(nv, **i32)
        compare(label, lambda: P.bbox_count(x, y, z, lo, hi, nvt).reshape(1),
                lambda: P.bbox_count_multi(*one[:5], nvt.reshape(1)), errs)
    nvt = torch.tensor(n, **i32)
    timed(timer, lambda: P.bbox_count(x, y, z, lo, hi, nvt), lambda: P.bbox_count_multi(*one),
          12 * n, 12 * n, what=f"one block of {n} points")


# ---------------------------------------------------------------- phase 4


# oracles a later path reads again, computed once a run: key -> value
_ORACLES: dict = {}
_BACKGROUND: dict = {}  # "worker": the run's Background, while it runs


def background_tasks(root: Path) -> list:
    """[(key, make)]: the host work of the run that no path needs at once,
    in the order the paths need it, for the background worker: the exact
    sidecars of every dataset (the collect path), the numpy oracles of the
    LAST density queries (the density path), the experiments' synthetic
    stand-ins (doc for experiments 2 and 4, navvis3t for 6, as the CLI's
    --synthesize writes them) and their oracles, and paperscale's dataset
    and oracle (the drivers path). key is what kept() asks for."""
    big = root / "big" / "last"
    exp = root / "experiments"
    tasks = [(("index", d), lambda d=d: exact_index(d))
             for d in (root / "big" / "last", root / "big" / "las", root / "small" / "lazer",
                       root / "small" / "laz")]
    for query, match, bounds, cell, scope, _ in density_last_runs():
        tasks.append((("density", big, *query, cell, scope),
                      lambda m=match, c=cell, sc=scope, b=bounds:
                      density_oracle(big, m, c, sc, b)))
    box_s = parse_aabb(E2E_BOX_SMALL)
    tasks.append((("written", big, "--bounds", E2E_BOX_SMALL),
                  lambda: written_oracle(big, in_box(box_s))))
    for e in (2, 6):
        dataset = experiments.EXPERIMENT_DATASETS[e]
        tasks.append((("synthesize", exp, dataset), lambda d=dataset: experiments.synthesize_dataset(
            exp, d, EXP_FILES, EXP_POINTS, clustered=True)))
    for e in (2, 4, 6):
        tasks.append((("experiment", exp, e), lambda e=e: experiment_oracles(exp, e)))
    ps = paperscale_args(root)
    tasks.append((("paperscale", root / "paperscale"), lambda: [
        paperscale.main(["generate", *ps]), paperscale.main(["oracle", *ps])]))
    return tasks


def task_file(key) -> str:
    return hashlib.sha1(repr(key).encode()).hexdigest()[:16] + ".pkl"


def task_label(key) -> str:
    return " ".join(v.name if isinstance(v, Path) else str(v) for v in key)


class Background:
    """The background worker: background_tasks(root) in order in one process
    of its own (`chip_smoke.py --background-worker ROOT`), beside the paths,
    each result pickled under root/background. take(key) waits for one."""

    def __init__(self, root: Path):
        self.dir = root / "background"
        self.dir.mkdir()
        self.keys = {key for key, _ in background_tasks(root)}
        self.log = self.dir / "worker.log"
        with open(self.log, "w") as log:  # the worker keeps its own descriptor
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--background-worker", str(root)],
                stdout=log, stderr=subprocess.STDOUT)

    def has(self, key) -> bool:
        return key in self.keys

    def running(self) -> bool:
        return self.proc.poll() is None

    def take(self, key):
        path = self.dir / task_file(key)
        t0 = time.perf_counter()
        while not path.exists():
            if not self.running() and not path.exists():
                fail(f"the background worker exited {self.proc.returncode} before {key}:\n"
                     f"{self.log.read_text()[-4000:]}")
            time.sleep(0.1)
        with open(path, "rb") as f:
            seconds, result = pickle.load(f)
        path.unlink()
        print(f"  background {task_label(key)}: {seconds:.1f} s in the worker, waited "
              f"{time.perf_counter() - t0:.1f} s for it")
        return result

    def close(self) -> None:
        """Stops the worker if it still runs; its log's tail."""
        if self.running():
            self.proc.kill()
        self.proc.wait()
        print(f"background worker, exit {self.proc.returncode}; its log's end:")
        for line in self.log.read_text().strip().splitlines()[-12:]:
            print(f"  {line}")


def background_worker(argv: list[str]) -> int:
    """`chip_smoke.py --background-worker ROOT`: every background task, in
    order, each result pickled (atomically) for Background.take. It loads
    no jax and touches no card."""
    root = Path(argv[0])
    check_no_jax("background worker, start")
    for key, make in background_tasks(root):
        t0 = time.perf_counter()
        result = make()
        seconds = time.perf_counter() - t0
        path = root / "background" / task_file(key)
        with open(path.with_suffix(".tmp"), "wb") as f:
            pickle.dump((seconds, result), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path.with_suffix(".tmp"), path)
        print(f"{task_label(key)}: {seconds:.1f} s", flush=True)
    check_no_jax("background worker, end")
    return 0


def kept(key, make):
    """make(), computed once a run for key: by the background worker where
    key is one of its tasks, else here."""
    if key not in _ORACLES:
        bg = _BACKGROUND.get("worker")
        _ORACLES[key] = bg.take(key) if bg and bg.has(key) else make()
    return _ORACLES[key]


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
    return kept(("count", data_dir, box), lambda: column_oracle(
        data_dir, lambda r: aabb.contains_points(r.positions_world())))


def class_oracle(data_dir: Path, target: int) -> int:
    return kept(("class", data_dir, target), lambda: column_oracle(
        data_dir, lambda r: r.column("classification") == target))


def time_oracle(data_dir: Path, t0: float, t1: float) -> int:
    return kept(("time", data_dir, t0, t1), lambda: column_oracle(data_dir, in_time(t0, t1)))


def cli_output(args: list[str]) -> tuple[int, str]:
    """cli.main(args) in this process: its exit code and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def run_cli(args: list[str], pack: str) -> str:
    os.environ["AQPC_PACK"] = pack
    rc, out = cli_output(args)
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


def write_datasets(root: Path, part: str) -> None:
    """The end-to-end datasets: "big" 8 files x 8M points of LAS and LAST,
    "small" 2 x 2M of LAZER and LAZ."""
    if part == "big":
        synth.write_dataset(root / "big", n_files=8, points_per_file=8_000_000, seed=SEED,
                            formats=("las", "last"), clustered=True, point_format=3)
    else:
        synth.write_dataset(root / "small", n_files=2, points_per_file=2_000_000, seed=SEED,
                            formats=("lazer", "laz"), clustered=True, point_format=3)


def dataset_worker(argv: list[str]) -> int:
    """`chip_smoke.py --dataset-worker ROOT PART`: write_datasets in a
    process of its own, beside the build."""
    root, part = argv
    t0 = time.perf_counter()
    write_datasets(Path(root), part)
    print(f"{part}: written in {time.perf_counter() - t0:.1f} s")
    return 0


def start_dataset_writers(root: Path) -> list:
    """Both parts of the datasets, each written by a worker process."""
    return [(part, subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                     "--dataset-worker", str(root), part],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
            for part in ("big", "small")]


def join_dataset_writers(root: Path, writers: list) -> list[tuple]:
    """Waits for the writers; the datasets as the paths take them."""
    for part, proc in writers:
        out = proc.communicate(timeout=1200)[0]
        if proc.returncode != 0:
            fail(f"the {part} dataset writer exited {proc.returncode}:\n{out[-4000:]}")
        print(f"datasets {out.strip()} (a worker process, beside the build)")
    datasets = [(root / "big" / f, E2E_BOX_LARGE, E2E_TIME_LARGE, 64_000_000)
                for f in ("last", "las")]
    datasets += [(root / "small" / f, E2E_BOX_SMALL, E2E_TIME_SMALL, 4_000_000)
                 for f in ("lazer", "laz")]
    return datasets


def exact_index(data_dir: Path) -> list:
    """[(file, min/max, class bitmap, GPS ranges, points)]: each file's exact
    sidecar, as the index command builds it."""
    out = []
    for f in point_files(data_dir):
        r = open_point_cloud(f)
        out.append((f, *index.build_index(r), r.point_count))
        r.close()
    return out


def build_exact_indexes(datasets) -> None:
    """Exact sidecars (class bitmaps, GPS min/max) over every file, as the
    index command builds them; they replace the bbox path's auto-built ones,
    which prune nothing for class and time plans."""
    for data_dir, *_ in datasets:
        t0 = time.perf_counter()
        for f, mm, bitmap, gps, n_points in kept(("index", data_dir),
                                                 lambda: exact_index(data_dir)):
            index.save_index(f, mm, bitmap, gps, n_points=n_points)
        print(f"{data_dir.name}: exact index built and saved in {time.perf_counter() - t0:.1f} s")


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
            want = class_oracle(data_dir, target)
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
        want = time_oracle(data_dir, t0, t1)
        print(f"{data_dir.name}: {n_points} points, time [{t0}, {t1}) oracle {want} matching")
        for pack, use_index in runs:
            out = cli_count(data_dir, ["--time-range", f"{t0};{t1}"], pack, use_index, want)
            if use_index and pruned_points(out) == 0:
                fail(f"{data_dir.name}: the exact index did not prune the time range")


def in_box(box: AABB):
    """The numpy match of the closed box."""
    return lambda r: box.contains_points(r.positions_world())


def in_time(t0: float, t1: float):
    """The numpy match of the half-open GPS-time range [t0, t1)."""
    def match(r):
        g = r.column("gps_time")
        return (g >= t0) & (g < t1)
    return match


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
    check_files(wrote, want, label)
    return wrote


def check_files(wrote: list[Path], want: list, label: str) -> None:
    """The files wrote, in order, are matching_points_0.. and each holds
    exactly the points of its (header, records) of the oracle."""
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
            want = kept(("written", big, *query), lambda: written_oracle(big, match))
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


def density_oracle(data_dir: Path, match, cell: float, scope: str, bounds=None) -> list:
    """The numpy oracle of a density query, independent of GridSpec3D: the
    reference's f64 cell (w - bmin) * dims / ext, truncated (negative and
    NaN to 0), its masked bit-packed key, and d2 to the unmasked cell's
    centre summed x, y, z in order; per key the least (d2, file order,
    point index) wins. bounds: the grid's (min, max), default the union of
    the files' header bounds. Returns the predicate's hit count and the
    written files as written_oracle gives them: one (header, records) per
    input file with winners (scope file), or one in all, the files' winners
    in file order (scope global)."""
    files = point_files(data_dir)
    readers = [open_point_cloud(f) for f in files]
    if bounds is None:
        bounds = (np.min([r.header.bounds.min for r in readers], 0),
                  np.max([r.header.bounds.max for r in readers], 0))
    bmin = np.asarray(bounds[0], np.float64)
    ext = np.asarray(bounds[1], np.float64) - bmin
    ncf = np.ceil(ext / cell)
    dims = np.maximum(ncf, 0.0)
    bits = [int(np.ceil(np.log2(v))) if v > 1 else 0 for v in ncf]
    keys, d2s, fidx, pidx = [], [], [], []
    for i, r in enumerate(readers):
        rows = np.nonzero(match(r))[0]
        if not len(rows):
            continue
        w = r.positions_world()[rows]
        with np.errstate(divide="ignore", invalid="ignore"):
            c = (w - bmin) * dims / ext
        c = np.where(np.isnan(c), 0.0, np.maximum(c, 0.0)).astype(np.uint64)
        d = w - ((c.astype(np.float64) + 0.5) * cell + bmin)
        d2s.append((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        key = np.zeros(len(rows), np.uint64)
        shift = 0
        for a in range(3):
            key |= (c[:, a] & np.uint64((1 << bits[a]) - 1)) << np.uint64(shift)
            shift += bits[a]
        keys.append(key)
        fidx.append(np.full(len(rows), i, np.int64))
        pidx.append(rows)
    want = []
    if keys:
        key, d2, fi, pi = (np.concatenate(v) for v in (keys, d2s, fidx, pidx))
        if scope == "file":
            key = key + (fi.astype(np.uint64) << np.uint64(sum(bits)))  # one grid per file
        # stable: ties on (key, d2) keep file order, then point order
        order = np.lexsort((d2, key))
        first = np.ones(len(order), bool)
        first[1:] = key[order][1:] != key[order][:-1]
        win_f, win_p = fi[order][first], pi[order][first]
        parts = []
        for i, r in enumerate(readers):
            rows = np.sort(win_p[win_f == i])
            if len(rows):
                parts.append((r.positions_world()[rows], r.column("classification")[rows],
                              r.column("color")[rows], r.column("intensity")[rows]))
        if scope == "global" and parts:
            parts = [tuple(np.concatenate([p[j] for p in parts]) for j in range(4))]
        for pos, cls, color, intensity in parts:
            header = make_writeback_header(len(pos), pos.min(0), pos.max(0), point_format=2)
            want.append((header, encode_point_records(header, pos, cls, color, intensity)))
    for r in readers:
        r.close()
    return sum(len(p) for p in pidx), want


def density_last_runs() -> list:
    """The density path's queries over LAST 64M: (query, match, grid bounds,
    cell, scope, [(AQPC_PACK, index read)]). A 0.5 m cell keeps most of the
    small box's hits, a 25 m one under 1 %."""
    box_l, box_s = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_SMALL)
    return [
        (["--bounds", E2E_BOX_SMALL], in_box(box_s), (box_s.min, box_s.max), 0.5, "global",
         [("1", False), ("0", False)]),
        (["--bounds", E2E_BOX_SMALL], in_box(box_s), (box_s.min, box_s.max), 25.0, "file",
         [("1", True), ("0", True)]),
        (["--bounds", E2E_BOX_LARGE], in_box(box_l), (box_l.min, box_l.max), 25.0, "global",
         [("1", False), ("0", True)]),
        (["--class", "6"], lambda r: r.column("classification") == 6, None, 5.0, "global",
         [("1", True), ("0", True)]),
    ]


def path_density(datasets) -> None:
    """--density with -o over LAST 64M and LAZER 4M, and one --print-points
    run; the exact sidecars of the collect path are in place."""
    big, small = datasets[0][0], datasets[2][0]
    box_s = parse_aabb(E2E_BOX_SMALL)
    with tempfile.TemporaryDirectory(prefix="aqpc_density_") as tmp:
        tmp = Path(tmp)
        for q, (query, match, bounds, cell, scope, runs) in enumerate(density_last_runs()):
            t0 = time.perf_counter()
            hits, want = kept(("density", big, *query, cell, scope),
                              lambda: density_oracle(big, match, cell, scope, bounds))
            n_want = sum(len(recs) for _, recs in want)
            print(f"{big.name}: {' '.join(query)} --density {cell} --density-scope {scope}: "
                  f"oracle {n_want} winners of {hits} hits ({100 * n_want / hits:.2f} %) in "
                  f"{len(want)} files ({time.perf_counter() - t0:.1f} s)")
            flags = [*query, "--density", str(cell), "--density-scope", scope]
            for n, (pack, use_index) in enumerate(runs):
                out_dir = tmp / f"last_{q}_{n}"
                cli_collect(big, flags, pack, use_index, want, out_dir)
                shutil.rmtree(out_dir)
            del want
        flags = ["--bounds", E2E_BOX_SMALL, "--density", "2.0"]
        _, want = density_oracle(small, in_box(box_s), 2.0, "global", (box_s.min, box_s.max))
        dirs = [tmp / f"lazer_{device}" for device in ("cuda", "cpu")]
        for device, out_dir in zip(("cuda", "cpu"), dirs):
            cli_collect(small, flags, "1", True, want, out_dir, device)
        names = sorted(p.name for p in dirs[0].iterdir())
        if names != sorted(p.name for p in dirs[1].iterdir()) or not all(
                filecmp.cmp(dirs[0] / f, dirs[1] / f, shallow=False) for f in names):
            fail(f"{small.name} -o {' '.join(flags)}: the card's files differ from the CPU's")
        print(f"  {small.name} -o {' '.join(flags)}: {len(names)} files byte-identical to the "
              f"--device cpu run's")
        box_p = parse_aabb(E2E_BOX_PRINT)
        want = sum(len(recs) for _, recs in density_oracle(
            small, in_box(box_p), 5.0, "global", (box_p.min, box_p.max))[1])
        texts = []
        for device in ("cuda", "cpu"):
            out = run_cli(["-i", str(small), "--bounds", E2E_BOX_PRINT, "--density", "5.0",
                           "--device", device, "--print-points"], "1")
            lines = [line for line in out.splitlines() if line.startswith("Found point: (")]
            texts.append(lines)
            print(f"  {small.name} --print-points --bounds {E2E_BOX_PRINT} --density 5.0 on "
                  f"{device}: {len(lines)} points printed, oracle {want}")
            if len(lines) != want or f"Found {want} matching points" not in out:
                fail(f"{small.name} --density --print-points on {device}: {len(lines)} lines, "
                     f"oracle {want}")
        if texts[0] != texts[1]:
            fail(f"{small.name} --density --print-points: the card's text differs from the CPU's")


def path_probe(datasets) -> None:
    """The bbox probe tool at 2^24 points: every bbox row, the two probe
    variants among them, gives the same count (the tool raises if not)."""
    del datasets
    bboxprobe.main(["--n", str(PROBE_N), "--iters", "8", "--device", "cuda"])


def resident_collect(data_dir: Path, query: list[str], want: list, out_dir: Path) -> None:
    """One CLI collect with --resident -o; its count and every written file
    must equal the oracle's."""
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    out = run_cli(["-i", str(data_dir), *query, "--device", "cuda", "--resident",
                   "-o", str(out_dir)], "1")
    wall = time.perf_counter() - t0
    label = f"{data_dir.name} --resident -o {' '.join(query)}"
    found = int(re.search(r"^Found (\d+) matching points$", out, re.M).group(1))
    n_want = sum(len(recs) for _, recs in want)
    if found != n_want:
        fail(f"{label}: found {found}, oracle {n_want}")
    wrote = check_written(out, want, label)
    lines = out.strip().splitlines()
    print(f"  {label}: found {found} in {len(wrote)} files equal to the oracle's; {wall:.3f} s; "
          f"{lines[0]}; {lines[-1]}")


def resident_split(fn, wall_ms: float, runs: int = 20) -> str:
    """Where one resident query's time goes: torch.profiler's device work of
    runs queries, per query, by kind (the count kernel; the fills and the
    bounds' join; the H2D of the per-query bounds or range; the D2H of the
    counts), and the host's share: the query's wall, wall_ms, less all of
    the device's work. The trace may lose records: a query launches its
    count kernel once, so the kernel records it holds are the queries it
    saw, and every kind is divided by them."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    parts = {"kernel": 0.0, "fills and joins": 0.0, "H2D": 0.0, "D2H": 0.0}
    seen = 0  # the queries whose kernel record the trace holds
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if not us:
            continue
        kind = ("H2D" if "HtoD" in e.key else "D2H" if "DtoH" in e.key
                else "kernel" if "_count" in e.key else "fills and joins")
        parts[kind] += us / 1e3
        seen += e.count if kind == "kernel" else 0
    if not seen:
        return "not measured (no kernel in the profiler's trace)"
    parts = {k: v / seen for k, v in parts.items()}
    device = sum(parts.values())
    return (", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; host (wall less device) {wall_ms - device:.4f} ms; the trace held "
              f"{seen} of {runs} queries' kernels")


def serve_run(data_dir: Path, tmp: Path, wants: dict) -> None:
    """`serve` as a subprocess on the card over stdin: info, the box, class
    6, the time range, a collect with limit 3 and an output dir over a small
    box, a line that is not JSON, quit; a reply for every line, each
    count the oracle's, the written files the oracle's."""
    box_l, box_p = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_PRINT)
    out_dir = tmp / "served"
    out_dir.mkdir()
    requests = [
        {"cmd": "info"},
        {"bounds": [*box_l.min, *box_l.max]},
        {"class": 6},
        {"time_range": list(E2E_TIME_LARGE)},
        {"bounds": [*box_p.min, *box_p.max], "collect": True, "limit": 3},
        {"bounds": [*box_p.min, *box_p.max], "output": str(out_dir)},
    ]
    lines = [json.dumps(r) for r in requests] + ["not json", json.dumps({"cmd": "quit"})]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli", "serve", "-i",
         str(data_dir), "--device", "cuda"],
        input="\n".join(lines) + "\n", capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    replies = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    print(f"  serve -i {data_dir.name} --device cuda: {len(lines)} lines, {len(replies)} replies "
          f"in {wall:.3f} s")
    for reply in replies:
        print(f"    {json.dumps(reply)[:300]}")
    if len(replies) != 1 + len(lines):
        fail(f"serve: {len(replies)} replies to {len(lines)} lines and the ready line")
    ready, info, box, cls6, tr, pts, output, bad, bye = replies
    n = wants["points"]
    if not ready.get("ready") or ready["points"] != n or info["points"] != n:
        fail(f"serve: ready {ready}, info {info}, {n} points")
    if info["devices"] != torch.cuda.device_count():
        fail(f"serve: info {info}, {torch.cuda.device_count()} cards")
    for label, reply, want in (("box", box, wants["box"]), ("class 6", cls6, wants["class 6"]),
                               ("time", tr, wants["time"]),
                               ("collect", pts, wants["small box"]),
                               ("output", output, wants["small box"])):
        if reply.get("count") != want:
            fail(f"serve {label}: {reply}, oracle {want}")
    if len(pts["points"]) != 3 or pts["truncated"] is not True or not all(
            box_p.contains_points(np.asarray([p[:3]]))[0] for p in pts["points"]):
        fail(f"serve collect: {pts}")
    check_written("\n".join(f"Wrote {f}" for f in output["files"]),
                  written_oracle(data_dir, lambda r: box_p.contains_points(r.positions_world())),
                  "serve output")
    if not bad.get("error", "").startswith("bad json") or bye != {"bye": True}:
        fail(f"serve: {bad}, {bye}")


def path_resident(datasets) -> None:
    """The LAST 64M dataset loaded into device memory through the CLI: the
    box, class 6, class 4 and the time range with --resident --repeat 20,
    each one launch of its count kernel a query and the oracle's count; -o
    of the box and of a time range, density -o of the small box at file
    scope and of class 6, each the oracle's files; ms a query for each
    predicate (median of 20) with a profiler split, in this process; and
    `serve` as a subprocess."""
    big = datasets[0][0]
    box_l, box_s = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_SMALL)
    t0, t1 = E2E_TIME_LARGE
    wants = {
        "box": oracle(big, E2E_BOX_LARGE),
        "class 6": class_oracle(big, 6),
        "class 4": class_oracle(big, 4),
        "time": time_oracle(big, t0, t1),
        "small box": oracle(big, E2E_BOX_PRINT),
        "points": sum(open_point_cloud(f).point_count for f in point_files(big)),
    }
    print(f"{big.name}: {wants['points']} points, oracles {wants}")
    counts = [
        ("box", ["--bounds", E2E_BOX_LARGE], "bbox_count_multi",
         QueryPlan(bounds=BoundsQuery(box_l)), 12),
        ("class 6", ["--class", "6"], "class_count_words",
         QueryPlan(classification=ClassQuery(6)), 1),
        ("class 4", ["--class", "4"], "class_count_words",
         QueryPlan(classification=ClassQuery(4)), 1),
        ("time", ["--time-range", f"{t0};{t1}"], "time_count_multi",
         QueryPlan(time_range=TimeRangeQuery(t0, t1)), 8),
    ]
    for label, query, kernel, _, _ in counts:
        before = dict(P.launches)
        out = run_cli(["-i", str(big), *query, "--device", "cuda", "--resident", "--repeat",
                       str(RESIDENT_REPEAT)], "1")
        launched = {k: v - before[k] for k, v in P.launches.items() if v != before[k]}
        found = int(re.search(r"^Found (\d+) matching points$", out, re.M).group(1))
        lines = out.strip().splitlines()
        print(f"  {big.name} --resident --repeat {RESIDENT_REPEAT} {' '.join(query)}: found "
              f"{found}, oracle {wants[label]}; {lines[0]}; {lines[-1]}; launches {launched}")
        if found != wants[label]:
            fail(f"{big.name} --resident {' '.join(query)}: found {found}, oracle {wants[label]}")
        if launched != {kernel: (RESIDENT_REPEAT + 1) * torch.cuda.device_count()}:
            fail(f"{big.name} --resident {' '.join(query)}: launched {launched}, not {kernel} "
                 f"once a query")

    with tempfile.TemporaryDirectory(prefix="aqpc_resident_") as tmp:
        tmp = Path(tmp)
        resident_collect(big, ["--bounds", E2E_BOX_LARGE],
                         kept(("written", big, "--bounds", E2E_BOX_LARGE),
                              lambda: written_oracle(big, in_box(box_l))), tmp / "box")
        lo, hi = E2E_TIME_COLLECT
        resident_collect(big, ["--time-range", f"{lo};{hi}"],
                         kept(("written", big, "--time-range", lo, hi),
                              lambda: written_oracle(big, in_time(lo, hi))), tmp / "time")
        for query, match, bounds, cell, scope in (
                (["--bounds", E2E_BOX_SMALL], in_box(box_s), (box_s.min, box_s.max), 25.0, "file"),
                (["--class", "6"], lambda r: r.column("classification") == 6, None, 5.0,
                 "global")):
            _, want = kept(("density", big, *query, cell, scope),
                           lambda: density_oracle(big, match, cell, scope, bounds))
            resident_collect(big, [*query, "--density", str(cell), "--density-scope", scope],
                             want, tmp / f"density_{cell}")

        # ms a query and where it goes, on one dataset with every column
        t = time.perf_counter()
        ds = ResidentDataset.load(big, device="cuda",
                                  attrs=("position", "classification", "gps_time"))
        print(f"  in this process: {ds.total_points} points, {ds.n_blocks} blocks of "
              f"{ds.block_size}, {ds.resident_bytes / 2**20:.1f} MiB on the card, loaded in "
              f"{time.perf_counter() - t:.2f} s")
        smi = smi_line()
        timer = KernelTimer(ds.device, TIMED_RUNS)
        for label, _, kernel, plan, bytes_a_point in counts:
            if ds.count(plan) != wants[label]:
                fail(f"resident count {label}: not the oracle's {wants[label]}")
            # the count entry's call alone on the query's operands: its
            # device work (the kernel and its fills), L2 flushed
            _, operands = ds._operands(plan, ds.shards[0], 0, ds.n_blocks,
                                       ds._box_table(plan)[0])
            if kernel == "class_count_words":
                operands = (operands[0].view(torch.int32), *operands[1:])
            entry = getattr(P, f"{kernel}_kernel")
            entry_ms, entry_least = timer.times(lambda: entry(*operands), device=True)
            walls = []
            for _ in range(RESIDENT_REPEAT):
                t = time.perf_counter()
                found = ds.count(plan)
                walls.append((time.perf_counter() - t) * 1e3)
                if found != wants[label]:
                    fail(f"resident count {label}: found {found}, oracle {wants[label]}")
            wall = statistics.median(walls)
            bound_ms, _ = bound_of(bytes_a_point * ds.total_points, ds.total_points)
            print(f"  resident {label} ({kernel}): {wall:.4f} ms a query (median of "
                  f"{RESIDENT_REPEAT}, least {min(walls):.4f}; {ds.total_points} points); the "
                  f"count entry's device work {entry_ms:.4f} ms (least {entry_least:.4f}; "
                  f"{bytes_a_point * ds.total_points / entry_ms / 1e6:.1f} GB/s), its bound "
                  f"{bound_ms:.4f} ms; {smi}")
            print(f"    one query (torch.profiler, 20 queries): "
                  f"{resident_split(lambda: ds.count(plan), wall)}")
        _RESIDENT["one shard"] = ds  # the devices path's one-shard dataset
        serve_run(big, tmp, wants)


# ---------------------------------------------------------------- devices


_RESIDENT: dict = {}  # the resident path's one-shard dataset, for the devices path


def card_launches() -> dict:
    """(kernel, card) -> launches so far (predicate.device_launches)."""
    return dict(P.device_launches)


def launched_since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in P.device_launches.items()
            if n != before.get(k, 0)}


def check_shard_launches(label: str, one: dict, two: dict, rule: str) -> None:
    """one, two: the (kernel, card) launches of a query at one shard and at
    two shards on card 0. Every kernel of the one-shard run launches on
    card 0 at two shards, and nowhere else. rule "twice": exactly twice as
    often (a launch a shard); "steps": 2 x ceil(n / 2) (a streamed step of
    2 x K blocks is two launches of K, where one shard's steps are one
    launch of K each); "some": at least once (the compaction, which only a
    shard with partial blocks launches, and density's per-file flushes)."""
    if {card for _, card in one} != {0} or {card for _, card in two} != {0}:
        fail(f"{label}: launched on {sorted(one)} and {sorted(two)}, not on card 0 alone")
    for (kernel, _), n in one.items():
        m = two.get((kernel, 0), 0)
        want = {"twice": 2 * n, "steps": 2 * -(-n // 2)}.get(rule)
        if (want is not None and m != want) or m < 1:
            fail(f"{label}: {kernel} launched {n} times at one shard, {m} at two; rule {rule}")
    if {k for k, _ in two} != {k for k, _ in one}:
        fail(f"{label}: kernels {sorted(two)} at two shards, {sorted(one)} at one")


def shard_runs(label: str, run, check, rule: str, smi: str) -> None:
    """run(devices) at one shard and at two shards on card 0, each checked
    (check(result)); the launch rule of check_shard_launches and both walls
    with the card's name and power limit."""
    results, walls, launches = [], [], []
    for devices in ([torch.device("cuda", 0)], [torch.device("cuda", 0)] * 2):
        before = card_launches()
        t0 = time.perf_counter()
        results.append(run(devices))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(launched_since(before))
        check(results[-1])
    check_shard_launches(label, *launches, rule)
    print(f"  {label}: {results[1]}; {walls[0] * 1e3:.3f} ms at one shard, "
          f"{walls[1] * 1e3:.3f} ms at two on cuda:0; launches at two "
          f"{ {k: n for (k, _), n in launches[1].items()} }; {smi}")


def path_devices(datasets) -> None:
    """Several devices in one process (parallel/mesh.py) over LAST 64M,
    with no new data: two shards on card 0 through run_query(devices=
    [cuda:0, cuda:0]) and a resident dataset over the same two shards,
    each query also at one shard. The box counts in both transports, class
    6 and the time range, index off; -o of the small box, every written
    file the oracle's; density of the large box at 25 m, global scope, the
    oracle's winners; the resident counts, -o of one second of GPS time and
    density of class 6 at 5 m against the resident path's one-shard
    dataset. Every answer is the oracle's and the one shard's; the launches
    at two shards follow check_shard_launches' rules; walls at one shard
    and at two. With more than one card: the box through the CLI's
    --devices over every card (each launches), and one kernel launched on
    cuda:1 while cuda:0 is current, against its plain version."""
    big = datasets[0][0]
    box_l, box_s = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_SMALL)
    t0, t1 = E2E_TIME_LARGE
    smi = smi_line()
    counts = [
        ("box AQPC_PACK=1", "1", QueryPlan(bounds=BoundsQuery(box_l)), oracle(big, E2E_BOX_LARGE)),
        ("box AQPC_PACK=0", "0", QueryPlan(bounds=BoundsQuery(box_l)), oracle(big, E2E_BOX_LARGE)),
        ("class 6", "1", QueryPlan(classification=ClassQuery(6)), class_oracle(big, 6)),
        ("time", "1", QueryPlan(time_range=TimeRangeQuery(t0, t1)), time_oracle(big, t0, t1)),
    ]

    def expect(label, want):
        def check(got):
            if got != want:
                fail(f"devices {label}: {got}, the oracle's {want}")
        return check

    for label, pack, plan, want in counts:
        os.environ["AQPC_PACK"] = pack
        shard_runs(f"{label} count", lambda devs, plan=plan: engine.run_query(
            big, plan, device="cuda", devices=devs, use_index=False).match_count,
            expect(label, want), "steps", smi)

    written = kept(("written", big, "--bounds", E2E_BOX_SMALL),
                   lambda: written_oracle(big, in_box(box_s)))
    hits_l, density_l = kept(("density", big, "--bounds", E2E_BOX_LARGE, 25.0, "global"),
                             lambda: density_oracle(big, in_box(box_l), 25.0, "global",
                                                    (box_l.min, box_l.max)))
    os.environ["AQPC_PACK"] = "1"
    with tempfile.TemporaryDirectory(prefix="aqpc_devices_") as tmp:
        tmp = Path(tmp)

        def written_run(plan, want, name):
            def run(devices):
                out_dir = tmp / f"{name}_{len(devices)}"
                out_dir.mkdir()
                res = engine.run_query(big, dataclasses.replace(plan, output_dir=out_dir),
                                       device="cuda", devices=devices, use_index=False)
                check_files(res.output_files, want, f"devices {name} at {len(devices)} shards")
                shutil.rmtree(out_dir)
                return res.match_count
            return run

        shard_runs("-o small box", written_run(QueryPlan(bounds=BoundsQuery(box_s)), written,
                                               "box"),
                   expect("-o small box", sum(len(r) for _, r in written)), "some", smi)
        plan = QueryPlan(bounds=BoundsQuery(box_l), density=DensityConfig(25.0, "global"))
        shard_runs("--density 25 global, large box", written_run(plan, density_l, "density"),
                   expect("density", sum(len(r) for _, r in density_l)), "some", smi)

        one = _RESIDENT.pop("one shard")
        t = time.perf_counter()
        two = ResidentDataset.load(big, devices=[torch.device("cuda", 0)] * 2,
                                   attrs=("position", "classification", "gps_time"))
        print(f"  resident over two shards on cuda:0: {two.n_blocks} blocks (one shard: "
              f"{one.n_blocks}), {[b / 2**20 for b in two.per_device_bytes]} MiB a shard, "
              f"loaded in {time.perf_counter() - t:.2f} s")
        if two.n_blocks % 2 or [s.device.index for s in two.shards] != [0, 0]:
            fail(f"resident over two shards: {two.n_blocks} blocks on "
                 f"{[str(s.device) for s in two.shards]}")
        by_shards = {1: one, 2: two}
        for label, _, plan, want in counts[::2] + counts[3:]:
            shard_runs(f"resident {label} count",
                       lambda devs, plan=plan: by_shards[len(devs)].count(plan),
                       expect(f"resident {label}", want), "twice", smi)
        lo, hi = E2E_TIME_COLLECT
        time_written = kept(("written", big, "--time-range", lo, hi),
                            lambda: written_oracle(big, in_time(lo, hi)))

        def resident_written(devices):
            out_dir = tmp / f"resident_{len(devices)}"
            out_dir.mkdir()
            count, emitter = by_shards[len(devices)].collect(
                QueryPlan(time_range=TimeRangeQuery(lo, hi)), output_dir=out_dir)
            check_files(emitter.output_files, time_written,
                        f"devices resident -o at {len(devices)} shards")
            shutil.rmtree(out_dir)
            return count

        shard_runs("resident -o time range", resident_written,
                   expect("resident -o", sum(len(r) for _, r in time_written)), "some", smi)
        _, density_c = kept(("density", big, "--class", "6", 5.0, "global"),
                            lambda: density_oracle(big, lambda r: r.column("classification") == 6,
                                                   5.0, "global"))
        plan = QueryPlan(classification=ClassQuery(6), density=DensityConfig(5.0, "global"))
        winners = []

        def resident_density(devices):
            _, state = by_shards[len(devices)].density_states(plan)
            winners.append(state)
            return len(state)

        shard_runs("resident density class 6 5 m global", resident_density,
                   expect("resident density", sum(len(r) for _, r in density_c)), "some", smi)
        if not all(np.array_equal(winners[0][f], winners[1][f])
                   for f in ("key", "d2", "file_idx", "gidx")):
            fail("resident density: the two shards' winners differ from the one shard's")
        del one, two, by_shards
        torch.cuda.empty_cache()

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"  one card: the CLI's --devices over every card and the launch on cuda:1 "
              f"need two")
        return
    before = card_launches()
    out = run_cli(["-i", str(big), "--bounds", E2E_BOX_LARGE, "--device", "cuda", "--devices",
                   str(cards), "--no-index"], "1")
    on = {card for _, card in launched_since(before)}
    if f"Found {counts[0][3]} matching points" not in out or on != set(range(cards)):
        fail(f"--devices {cards}: launched on cards {sorted(on)}:\n{out}")
    print(f"  --devices {cards}: found {counts[0][3]}, launches on cards {sorted(on)}; "
          f"{out.strip().splitlines()[-1]}")
    gen = torch.Generator().manual_seed(SEED)
    second = torch.device("cuda", 1)
    args = [torch.randint(-5000, 5000, (4, 1 << 21), dtype=torch.int32, generator=gen)
            for _ in range(3)]
    args += [torch.full((4, 3), -2500, dtype=torch.int32), torch.full((4, 3), 2500,
                                                                       dtype=torch.int32),
             torch.full((4,), 1 << 21, dtype=torch.int32)]
    before = card_launches()
    with torch.cuda.device(0):
        got = P.bbox_count_multi_kernel(*(a.to(second) for a in args)).cpu()
    want = P.bbox_count_multi(*args)
    if not torch.equal(got, want) or launched_since(before) != {("bbox_count_multi", 1): 1}:
        fail(f"bbox_count_multi on cuda:1 with cuda:0 current: {got} against the plain "
             f"{want}; launches {launched_since(before)}")
    print(f"  bbox_count_multi on cuda:1 with cuda:0 current: {got.tolist()}, the plain "
          f"version's")


DIST_PROCS = 2  # processes of the distributed path, all on card 0
DIST_SHARDS = 2  # shards a process in the distributed path's run over several
DIST_TIMEOUT = 300.0  # seconds a run of the distributed path's workers may take
# the queries of the run over DIST_SHARDS shards a process, and the launch
# rule (check_shard_launches) each one's kernels follow against one shard
DIST_SHARD_QUERIES = {"box AQPC_PACK=1": "steps", "box AQPC_PACK=0": "steps",
                      "class 6 AQPC_PACK=1": "steps", "time AQPC_PACK=1": "steps",
                      "box -o": "some", "density 25 global large box -o": "some"}


def dist_queries(big: Path, out: Path) -> list[dict]:
    """The distributed path's query specs (tools/dist2.py) over the LAST
    64M dataset: the four counts in both transports, index off; -o of the
    box; density -o of the small box at 25 m, global and file scope, and of
    the large box at 25 m, global scope."""
    t0, t1 = E2E_TIME_LARGE
    queries = []
    for pack in ("1", "0"):
        for label, pred in (("box", {"bounds": E2E_BOX_LARGE}), ("class 6", {"class": 6}),
                            ("class 4", {"class": 4}), ("time", {"time": [t0, t1]})):
            queries.append({"name": f"{label} AQPC_PACK={pack}", "op": "count", "pack": pack,
                            "use_index": False, **pred})
    queries += [
        {"name": "box -o", "op": "collect", "bounds": E2E_BOX_LARGE, "out": str(out / "box")},
        {"name": "density 25 global -o", "op": "density", "bounds": E2E_BOX_SMALL,
         "density": [25.0, "global"], "out": str(out / "density_global")},
        {"name": "density 25 file -o", "op": "density", "bounds": E2E_BOX_SMALL,
         "density": [25.0, "file"], "out": str(out / "density_file")},
        {"name": "density 25 global large box -o", "op": "density", "bounds": E2E_BOX_LARGE,
         "density": [25.0, "global"], "out": str(out / "density_global_large")},
    ]
    for q in queries:
        q["data"] = str(big)
    return queries


def dist_run(big: Path, out: Path, procs: int, devices: int | None = None,
             names=None, env: dict | None = None) -> list[dict]:
    """dist_queries (those of names, or all) in procs worker processes on
    the card, devices shards each (one without), each started as
    `chip_smoke.py --dist2-worker` (dist2_worker); their reports."""
    t = time.perf_counter()
    queries = [q for q in dist_queries(big, out) if names is None or q["name"] in names]
    reports = dist2.run_workers(
        queries, procs=procs, device="cuda", devices=devices, timeout=DIST_TIMEOUT,
        command=[sys.executable, str(Path(__file__).resolve()), "--dist2-worker"], env=env)
    print(f"  {procs} process(es) on {[' + '.join(w['devices']) for w in reports]} "
          f"({reports[0]['device_name']}): ran in {time.perf_counter() - t:.1f} s with start-up; "
          f"{smi_line()}")
    return reports


def query_card_launches(report: dict, name: str) -> dict:
    """(kernel, card) -> launches of one query of a worker's report."""
    return {(k, card): n for k, card, n in report["queries"][name]["card_launches"]}


def dist2_worker(argv: list[str]) -> int:
    """A worker of the distributed path: tools/dist2.py's, between two
    checks that it loads no jax."""
    check_no_jax("dist2 worker, start")
    rc = dist2.worker_main(argv)
    check_no_jax("dist2 worker, end")
    return rc


def dist_cli_count(big: Path, want: int, smi: str) -> None:
    """The box counted by the CLI, as a user starts it: `cli --distributed
    --device cuda` in DIST_PROCS processes of one shard each, and at the
    same time, in a group of its own, `--devices DIST_SHARDS` in DIST_PROCS
    more (tools/dist2.py run_processes; on one card every shard is card
    0's). Each process must print the oracle's count in its Found line,
    over DIST_PROCS devices in the first group and DIST_PROCS x DIST_SHARDS
    in the second."""
    ports = {dist2.free_port()}
    while len(ports) < 2:  # a group a port
        ports.add(dist2.free_port())
    argvs, groups = [], []
    for port, shards in zip(sorted(ports), (None, DIST_SHARDS)):
        for pid in range(DIST_PROCS):
            argvs.append([sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli", "-i",
                          str(big), "--bounds", E2E_BOX_LARGE, "--device", "cuda",
                          "--distributed", "--coordinator", f"127.0.0.1:{port}",
                          "--num-processes", str(DIST_PROCS), "--process-id", str(pid),
                          *(["--devices", str(shards)] if shards else [])])
            groups.append((shards, DIST_PROCS * (shards or 1)))
    done = dist2.run_processes(argvs, timeout=DIST_TIMEOUT, env=dict(os.environ, AQPC_PACK="1"))
    walls = {}
    for (rc, out), (shards, n_devices), argv in zip(done, groups, argvs):
        found = re.compile(rf"^Found (\d+) matching points \({DIST_PROCS} process\(es\), "
                           rf"{n_devices} devices, ([\d.]+)s\)$", re.M)
        m = found.search(out)
        if rc != 0 or m is None or int(m.group(1)) != want:
            fail(f"{big.name} cli --distributed{f' --devices {shards}' if shards else ''} "
                 f"process {argv[argv.index('--process-id') + 1]} exited {rc}, want Found "
                 f"{want} over {n_devices} devices:\n{out[-4000:]}")
        walls.setdefault(shards, []).append(m.group(2))
    print(f"  cli --distributed --device cuda --bounds, {DIST_PROCS} processes: each found "
          f"{want} over {DIST_PROCS} devices in {', '.join(walls[None])} s; with --devices "
          f"{DIST_SHARDS}, over {DIST_PROCS * DIST_SHARDS} devices in "
          f"{', '.join(walls[DIST_SHARDS])} s (the two groups at once); {smi}")


def dist_check_collect(label: str, reports: list[dict], name: str, written: list,
                       hit_files: list[int]) -> None:
    """Each process's -o files are the oracle's files of its input files
    with hits (process p's j-th file is input file j * DIST_PROCS + p among
    those with hits)."""
    for w in reports:
        pid = w["pid"]
        sources = [j for j, i in enumerate(hit_files) if i % DIST_PROCS == pid]
        check_files([Path(f) for f in w["queries"][name]["files"]],
                    [written[j] for j in sources], f"{label}, process {pid}")


def dist_shards_run(big: Path, tmp: Path, one: dict, one_shard: list[dict], wants: dict,
                    written: list, hit_files: list[int], smi: str) -> list[dict]:
    """DIST_PROCS workers of DIST_SHARDS shards each, all on card 0, over
    the queries of DIST_SHARD_QUERIES: each count the oracle's, each
    process's -o files the oracle's of its input files, the global density
    winners' points the one-process run's (one). Each worker's launches of
    a query follow check_shard_launches' rule against the same worker's in
    the run of one shard a process (one_shard); each query's wall at one
    shard a process and at DIST_SHARDS. Returns the workers' reports."""
    cards = torch.cuda.device_count()
    # several cards: card 0 alone, as on a machine of one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0") if cards > 1 else None
    got = dist_run(big, tmp / "shards", DIST_PROCS, DIST_SHARDS, DIST_SHARD_QUERIES, env)
    if [w["devices"] for w in got] != [["cuda:0"] * DIST_SHARDS] * DIST_PROCS:
        fail(f"distributed, {DIST_SHARDS} shards a process: ran on "
             f"{[w['devices'] for w in got]}")
    for name, rule in DIST_SHARD_QUERIES.items():
        label = f"{big.name} distributed {name}, {DIST_SHARDS} shards a process"
        counts = [w["queries"][name]["count"] for w in got]
        if counts != [wants[name]] * DIST_PROCS:
            fail(f"{label}: counted {counts}, want {wants[name]}")
        if name == "box -o":
            dist_check_collect(label, got, name, written, hit_files)
        elif name.startswith("density"):
            files = [f for w in got for f in w["queries"][name]["files"]]
            one_files = one["queries"][name]["files"]
            if not files or dist2.point_rows(files) != dist2.point_rows(one_files):
                fail(f"{label}: the winners of {len(files)} files differ from the one "
                     f"process's {len(one_files)}")
        for w, w1 in zip(got, one_shard):
            before = query_card_launches(w1, name)
            if cards > 1:  # the one-shard run's process p was on card p % cards
                before = {(k, 0): n for (k, _), n in before.items()}
            check_shard_launches(f"{label}, process {w['pid']}", before,
                                 query_card_launches(w, name), rule)
        walls = [max(w["queries"][name]["seconds"] for w in run) for run in (one_shard, got)]
        launches = [{k: n for (k, _), n in query_card_launches(run[0], name).items()}
                    for run in (one_shard, got)]
        print(f"  {name}, {DIST_PROCS} processes: {wants[name]} in {walls[0]:.3f} s at one shard "
              f"a process, {walls[1]:.3f} s at {DIST_SHARDS} on cuda:0 (slowest process); "
              f"process 0's launches {launches[0]} at one shard, {launches[1]} at "
              f"{DIST_SHARDS}; {smi}")
    return got


def dist_disjoint_cards(big: Path, tmp: Path, want: int, smi: str) -> list[dict]:
    """With DIST_PROCS cards or more: DIST_PROCS workers of cards //
    DIST_PROCS shards each count the box; the processes' cards are
    disjoint, and each process's kernels launch on its own cards alone.
    With fewer cards a line says that this was not run. Returns the
    workers' reports."""
    cards = torch.cuda.device_count()
    if cards < DIST_PROCS:
        print(f"  {cards} card(s): the check that the processes' cards are disjoint (each "
              f"process's kernels on its own cards alone) was not run; it needs {DIST_PROCS}")
        return []
    name = "box AQPC_PACK=1"
    got = dist_run(big, tmp / "disjoint", DIST_PROCS, cards // DIST_PROCS, [name])
    owned = [{torch.device(d).index for d in w["devices"]} for w in got]
    if len(set().union(*owned)) != sum(len(o) for o in owned):
        fail(f"distributed over {cards} cards: the processes' cards {owned} overlap")
    for w, mine in zip(got, owned):
        on = {card for _, card, _ in w["queries"][name]["card_launches"]}
        if w["queries"][name]["count"] != want or not on or not on <= mine:
            fail(f"distributed over {cards} cards: process {w['pid']} on cards {sorted(mine)} "
                 f"launched on {sorted(on)} and counted {w['queries'][name]['count']}, want "
                 f"{want}")
    print(f"  {name} over {cards} cards, {DIST_PROCS} processes of {cards // DIST_PROCS}: "
          f"cards {[sorted(o) for o in owned]}, each process's launches on its own; "
          f"{max(w['queries'][name]['seconds'] for w in got):.3f} s; {smi}")
    return got


def path_distributed(datasets) -> dict:
    """The LAST 64M dataset queried by two processes on the one card
    (parallel/distributed.py through tools/dist2.py; 4 files a process),
    and by one process: every count equals the numpy oracle in both runs;
    the -o files of the box, host0/ and host1/ together, are the oracle's
    (process p's j-th file is input file j * 2 + p among the files with
    hits); density's count and winners in two processes equal one
    process's, whose file-scope files and large-box global file equal the
    numpy oracle's. The wall of each query in one process against two,
    with the card's name and power limit. Then two processes of two shards
    each on card 0 (dist_shards_run), with more cards a run on disjoint
    cards (dist_disjoint_cards), and the box through the CLI's
    --distributed in two processes, with and without --devices
    (dist_cli_count). Returns the kernel launches of the workers together:
    the CLI processes report none."""
    big = datasets[0][0]
    box_l, box_s = parse_aabb(E2E_BOX_LARGE), parse_aabb(E2E_BOX_SMALL)
    t0, t1 = E2E_TIME_LARGE
    wants = {
        "box": oracle(big, E2E_BOX_LARGE),
        "class 6": class_oracle(big, 6),
        "class 4": class_oracle(big, 4),
        "time": time_oracle(big, t0, t1),
    }
    written = kept(("written", big, "--bounds", E2E_BOX_LARGE),
                   lambda: written_oracle(big, in_box(box_l)))
    # the box's files with hits: those whose header meets the box, every
    # one with hits (the oracle has as many files)
    hit_files = []
    for i, f in enumerate(point_files(big)):
        r = open_point_cloud(f)
        if r.header.bounds.intersects(box_l):
            hit_files.append(i)
        r.close()
    if len(hit_files) != len(written):
        fail(f"distributed: {len(hit_files)} files meet the box, the oracle has "
             f"{len(written)} with hits")
    _, density_file = kept(("density", big, "--bounds", E2E_BOX_SMALL, 25.0, "file"),
                           lambda: density_oracle(big, in_box(box_s), 25.0, "file",
                                                  (box_s.min, box_s.max)))
    _, density_l = kept(("density", big, "--bounds", E2E_BOX_LARGE, 25.0, "global"),
                        lambda: density_oracle(big, in_box(box_l), 25.0, "global",
                                               (box_l.min, box_l.max)))
    smi = smi_line()
    wanted = {}
    launched: dict = {}
    with tempfile.TemporaryDirectory(prefix="aqpc_distributed_") as tmp:
        tmp = Path(tmp)
        (one,) = dist_run(big, tmp / "one", 1)
        got = dist_run(big, tmp / "two", DIST_PROCS)
        for q in dist_queries(big, tmp):
            name = q["name"]
            counts = [w["queries"][name]["count"] for w in [one, *got]]
            label = f"{big.name} distributed {name}"
            want = wants.get(name.split(" AQPC_PACK")[0])
            if want is None and q["op"] == "collect":
                want = sum(len(recs) for _, recs in written)
            if want is None and q.get("bounds") == E2E_BOX_LARGE:  # the large box's density
                want = sum(len(recs) for _, recs in density_l)
            if want is None:
                want = counts[0]  # density: the one process's count
            wanted[name] = want
            if counts != [want] * len(counts):
                fail(f"{label}: counted {counts} (one process, then each of "
                     f"{DIST_PROCS}), want {want}")
            one_files = [Path(f) for f in one["queries"][name]["files"]]
            if q["op"] == "collect":
                check_files(one_files, written, f"{label}, one process")
                dist_check_collect(label, got, name, written, hit_files)
            elif q["op"] == "density":
                files = [f for w in got for f in w["queries"][name]["files"]]
                if q["density"][1] == "file":
                    check_files(one_files, density_file, f"{label}, one process")
                    same = dist2.file_digests(files) == dist2.file_digests(one_files)
                else:
                    if q["bounds"] == E2E_BOX_LARGE:
                        check_files(one_files, density_l, f"{label}, one process")
                    same = dist2.point_rows(files) == dist2.point_rows(one_files)
                if not same or not files:
                    fail(f"{label}: the {DIST_PROCS} processes' {len(files)} files differ "
                         f"from the one process's {len(one_files)}")
            walls = [w["queries"][name]["seconds"] for w in got]
            print(f"  {name}: {want} in {one['queries'][name]['seconds']:.3f} s in one process, "
                  f"{max(walls):.3f} s in {DIST_PROCS} (each {', '.join(f'{s:.3f}' for s in walls)}"
                  f"){f'; {len(one_files)} files' if one_files else ''}; {smi}")
        t = time.perf_counter()
        shards = dist_shards_run(big, tmp, one, got, wanted, written, hit_files, smi)
        shards += dist_disjoint_cards(big, tmp, wants["box"], smi)
        print(f"  the runs over several shards a process: {time.perf_counter() - t:.1f} s; {smi}")
    t = time.perf_counter()
    dist_cli_count(big, wants["box"], smi)
    print(f"  the CLI's two groups: {time.perf_counter() - t:.1f} s; {smi}")
    for w in got + shards:
        for kernel, n in w["launches"].items():
            launched[kernel] = launched.get(kernel, 0) + n
    print(f"  launches of the one-process run: {one['launches']}")
    return launched


# ---------------------------------------------------------------- drivers


CONVERT_COLUMNS = ("position", "intensity", "classification", "gps_time", "color")
# kernel counter -> its CUDA function's name, as a profiler trace's kernel
# events carry it (the profiled box counts launch these two)
KERNEL_SYMBOLS = {"bbox_count_multi": "bbox_count_multi_kernel",
                  "bbox_count_packed": "bbox_count_packed_kernel"}
EXP_POINTS, EXP_FILES = 2_000_000, 4  # the experiments' synthetic datasets: 8 M points each
MEMCHECK_POINTS = 64_000_000
PAPERSCALE_FILES, PAPERSCALE_POINTS = 4, 64_000_000  # 256 M points of LAST


def tool_output(label: str, main, args: list[str]) -> str:
    """A tool's main(args) in this process, which must exit 0; its standard
    output."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    out = buf.getvalue()
    if rc != 0:
        fail(f"{label} exited {rc}:\n{out[-6000:]}")
    print(f"  {label}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out


def drivers_count_points(big: Path, n_points: int) -> None:
    rc, out = cli_output(["count-points", "-i", str(big)])
    if rc != 0 or out != f"Total number of points: {n_points}\n":
        fail(f"count-points -i {big.name}: exit {rc}, {out!r}")
    print(f"  count-points -i {big.name}: {out.strip()}")


def drivers_convert(src: Path, box: str, tmp: Path) -> None:
    """One LAS file to LAST, LAZER and LAZ through the CLI: every output
    holds the source's columns, and the box count over it is the source's
    oracle."""
    aabb = parse_aabb(box)
    r = open_point_cloud(src)
    columns = {name: r.column(name) for name in CONVERT_COLUMNS}
    want = int(np.count_nonzero(aabb.contains_points(r.positions_world())))
    n = r.point_count
    r.close()
    for fmt in ("last", "lazer", "laz"):
        out_dir = tmp / f"convert_{fmt}"
        out_dir.mkdir()
        dst = out_dir / f"{src.stem}.{fmt}"
        t0 = time.perf_counter()
        rc, out = cli_output(["convert", "-i", str(src), "-o", str(dst)])
        wall = time.perf_counter() - t0
        if rc != 0 or out != f"Converted {src} -> {dst}\n":
            fail(f"convert -o .{fmt}: exit {rc}, {out!r}")
        r = open_point_cloud(dst)
        same = r.point_count == n and all(np.array_equal(r.column(name), col)
                                          for name, col in columns.items())
        r.close()
        if not same:
            fail(f"convert {src.name} -> .{fmt}: the columns read back differ from the source's")
        print(f"  convert {src.name} -> .{fmt} ({dst.stat().st_size / 1e6:.1f} MB) in {wall:.1f} s: "
              f"{n} points, {', '.join(CONVERT_COLUMNS)} equal to the source's")
        cli_count(out_dir, ["--bounds", box], "1", False, want)


def drivers_index(big: Path, box: str, tmp: Path) -> None:
    """`cli index` over a copy of the LAST files; then the box count reads
    the sidecars, prunes points and equals the oracle."""
    copy = tmp / "indexed"
    copy.mkdir()
    for f in point_files(big):
        shutil.copy(f, copy / f.name)
    t0 = time.perf_counter()
    rc, out = cli_output(["index", "-i", str(copy)])
    lines = out.splitlines()
    if rc != 0 or len(lines) != len(point_files(big)) or not all(
            re.fullmatch(r"Indexed \S+ -> \S+\.aqpc-idx \(\d+ blocks \+ gps\)", s) for s in lines):
        fail(f"index -i {copy}: exit {rc}:\n{out}")
    print(f"  index -i {copy.name}: {len(lines)} sidecars in {time.perf_counter() - t0:.1f} s; "
          f"{lines[0]}")
    out = cli_count(copy, ["--bounds", box], "1", True, oracle(big, box))
    if pruned_points(out) <= 0:
        fail(f"index: the box count over {copy.name} pruned no points")


def drivers_profile(big: Path, box: str, tmp: Path, smi: str) -> dict:
    """--profile DIR over the box count in both transports, index off,
    through cli.main in a fresh process (`chip_smoke.py --profile-worker`,
    profile_worker): each trace parses and its events of the port's
    kernels are printed beside that process's launch counters; every
    launched kernel has an event, and the first trace holds one event a
    launch. A fresh process, since a torch.profiler session in a
    long-lived one loses its first kernel records, up to all of them
    (PERF.md §7). Returns the worker's launches, for the path's kernel
    check."""
    want = oracle(big, box)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--profile-worker",
                           str(big), box, str(tmp)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"the --profile worker exited {proc.returncode}:\n{proc.stdout[-4000:]}"
             f"{proc.stderr[-4000:]}")
    runs = json.loads(proc.stdout.splitlines()[-1])
    print(f"  the --profile worker ran in {time.perf_counter() - t0:.1f} s with start-up")
    total = {}
    for i, (pack, run) in enumerate(runs.items()):
        trace_dir, launched = tmp / f"profile_{pack}", run["launches"]
        if (f"Profiler trace written to {trace_dir}" not in run["out"].splitlines()
                or f"Found {want} matching points" not in run["out"]):
            fail(f"--profile AQPC_PACK={pack}: want the trace line and Found {want}:\n{run['out']}")
        ours, others = traced_launches(trace_dir, launched)
        print(f"  --profile AQPC_PACK={pack} --bounds {box} index off: found {want} in "
              f"{run['seconds']:.3f} s (traced, profile {i + 1} of a fresh process); launches "
              f"{launched}, the trace's kernel events {ours}, other kernel events {others}; {smi}")
        if not launched or any(ours[k] < 1 for k in launched):
            fail(f"--profile AQPC_PACK={pack}: the trace holds {ours} of the launches {launched}")
        if i == 0 and ours != launched:
            fail(f"--profile AQPC_PACK={pack}, a fresh process's first trace: it holds {ours}, "
                 f"want {launched}")
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    return total


def profile_worker(argv: list[str]) -> int:
    """The --profile step's process: the box count over argv's dataset under
    cli.main's --profile in both transports, between two checks that it
    loads no jax. Its last line: per transport, the CLI's output, its wall
    and the launches it counted."""
    big, box, tmp = argv
    check_no_jax("profile worker, start")
    runs = {}
    for pack in ("1", "0"):
        before = dict(P.launches)
        t0 = time.perf_counter()
        out = run_cli(["-i", big, "--bounds", box, "--device", "cuda", "--no-index",
                       "--profile", str(Path(tmp) / f"profile_{pack}")], pack)
        runs[pack] = {"out": out, "seconds": time.perf_counter() - t0,
                      "launches": {k: n - before[k] for k, n in P.launches.items()
                                   if n > before[k]}}
    check_no_jax("profile worker, end")
    print(json.dumps(runs))
    return 0


def traced_launches(trace_dir: Path, launched: dict) -> tuple[dict, int]:
    """The kernel events of each launched kernel in the trace --profile
    wrote into trace_dir, and the trace's other kernel events."""
    names = [e["name"] for e in cli.profile_events(trace_dir, "kernel")]
    ours = {}
    for kernel in launched:
        if kernel not in KERNEL_SYMBOLS:
            fail(f"{trace_dir}: {kernel} launched, its kernel name is unknown")
        ours[kernel] = sum(KERNEL_SYMBOLS[kernel] in name for name in names)
    return ours, len(names) - sum(ours.values())


def drivers_devices(big: Path, box: str) -> None:
    """--devices 1 counts the oracle's matches on card 0; --devices of one
    more than the cards, and 0, exit 2 with a message."""
    want = oracle(big, box)
    out = run_cli(["-i", str(big), "--bounds", box, "--device", "cuda", "--devices", "1"], "1")
    if f"Found {want} matching points" not in out or not out.rstrip().endswith(" on cuda:0"):
        fail(f"--devices 1: want Found {want} on cuda:0:\n{out}")
    said = []
    for n in (torch.cuda.device_count() + 1, 0):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, out = cli_output(["-i", str(big), "--bounds", box, "--device", "cuda",
                                  "--devices", str(n)])
        if rc != 2 or out or not err.getvalue().startswith(f"--devices {n}: "):
            fail(f"--devices {n}: exit {rc}, {out!r}, {err.getvalue()!r}; want 2 and a message")
        said.append(f"--devices {n}: exit 2, {err.getvalue().strip()}")
    print(f"  --devices 1: found {want}; {'; '.join(said)}")


def experiment_oracles(root: Path, e: int) -> dict:
    """Row label (but its format) -> the numpy f64 oracle's count over the
    synthesized LAS files of experiment e: the box (full), the density
    winners at file scope (lod), the class, the GPS-time window."""
    dataset = experiments.EXPERIMENT_DATASETS[e]
    las = root / dataset / "las"
    want = {}
    if e <= 3:
        for size, box in experiments.AABBS[dataset].items():
            want[f"{dataset}_{size}_full"] = column_oracle(las, in_box(box))
            _, files = density_oracle(las, in_box(box), experiments.DENSITIES[dataset], "file",
                                      (box.min, box.max))
            want[f"{dataset}_{size}_lod"] = sum(h.point_count for h, _ in files)
    elif e <= 5:
        for name, value in experiments.CLASS_EXPERIMENTS:
            want[f"{dataset}_{name}"] = column_oracle(
                las, lambda r, v=value: r.column("classification") == v)
    else:
        span = sum(parse_las_header_file(f).point_count
                   for f in point_files(las)) / experiments.TIME_RATE
        for name, f0, f1 in experiments.TIME_EXPERIMENTS:
            want[f"{dataset}_{name}"] = column_oracle(las, in_time(f0 * span, f1 * span))
    return want


def drivers_experiments(exp: Path, smi: str) -> None:
    """The paper's harness through the CLI over its synthetic stand-ins
    (written by the background worker, as --synthesize writes them):
    experiment 2 as cold subprocesses, all sizes, full and max-density, its
    four formats at once, a harness process each; experiments 4 and 6 in
    this process, warm, 3 runs, over all four formats. Every row's count
    must equal the numpy oracle, so the formats agree (the harness checks
    cross-format parity itself within one process)."""
    for e in (2, 6):
        kept(("synthesize", exp, experiments.EXPERIMENT_DATASETS[e]), lambda: fail("no stand-in"))
    formats = experiments.FORMATS
    harness = [sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli", "experiments",
               "-i", str(exp), "--device", "cuda"]
    t0 = time.perf_counter()
    procs = []
    for fmt in formats:  # one harness a format, at once; each row is its own cold CLI process
        with open(exp / f"e2_{fmt}.out", "w") as out, open(exp / f"e2_{fmt}.err", "w") as err:
            procs.append(subprocess.Popen([*harness, "-e", "2", "--formats", fmt, "--runs", "1"],
                                          stdout=out, stderr=err,
                                          cwd=Path(__file__).resolve().parent))
    try:
        rcs = [proc.wait(timeout=900) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    outs = [(exp / f"e2_{fmt}.out").read_text() for fmt in formats]
    for fmt, rc, out in zip(formats, rcs, outs):
        if rc != 0:
            err = (exp / f"e2_{fmt}.err").read_text()
            fail(f"experiments -e 2 --formats {fmt} exited {rc}:\n{out[-2000:]}{err[-4000:]}")
    runs = [(2, "--runs 1, cold, a harness process a format, the four at once",
             "\n".join(outs), wall)]
    for e, extra in ((4, ["--in-process", "--warm", "--runs", "3"]),
                     (6, ["--in-process", "--warm", "--runs", "3"])):
        t0 = time.perf_counter()
        rc, out = cli_output(["experiments", "-i", str(exp), "-e", str(e), "--device", "cuda",
                              "--formats", ",".join(formats), *extra])
        if rc != 0:
            fail(f"experiments -e {e} exited {rc}:\n{out}")
        runs.append((e, " ".join(extra), out, time.perf_counter() - t0))
    for e, how, out, wall in runs:
        want = kept(("experiment", exp, e), lambda e=e: experiment_oracles(exp, e))
        rows = [line.split(";") for line in out.splitlines() if ";" in line]
        n_cells = len(want) * len(formats)
        print(f"  experiments -e {e} over {', '.join(formats)} ({how}): {len(rows)} rows in "
              f"{wall:.1f} s; {smi}")
        for row in rows:
            print(f"    {';'.join(row)}")
        got = {}
        for row in rows:
            got.setdefault(row[0].rsplit("_", 1)[0], []).append(row[4])
        if len(rows) != n_cells or any(got.get(k) != [str(v)] * len(formats)
                                       for k, v in want.items()):
            fail(f"experiments -e {e}: rows {got}, oracle {want}")
        print(f"  experiments -e {e}: every row's count equals the numpy oracle {want}")


def drivers_soak() -> None:
    os.environ["AQPC_PACK"] = "1"
    out = tool_output("soak --device cuda", soak.main, ["--device", "cuda"])
    lines = out.strip().splitlines()
    if sum(line.startswith("OK ") for line in lines) != 9 or not lines[-1].endswith(" 0 failures"):
        fail(f"soak: {out}")
    for line in lines:
        print(f"    {line}")


def drivers_memcheck() -> None:
    os.environ["AQPC_PACK"] = "1"
    out = tool_output(f"memcheck --device cuda --points {MEMCHECK_POINTS}", memcheck.main,
                      ["--device", "cuda", "--points", str(MEMCHECK_POINTS)])
    if "STREAMING OK" not in out:
        fail(f"memcheck: {out}")
    for line in out.strip().splitlines():
        print(f"    {line}")


def paperscale_args(root: Path) -> list[str]:
    return ["--root", str(root / "paperscale"), "--files", str(PAPERSCALE_FILES),
            "--pts-per-file", str(PAPERSCALE_POINTS)]


def drivers_paperscale(root: Path, smi: str) -> None:
    """paperscale at 4 x 64M LAST: generate and oracle by the background
    worker (the tool's own steps), then run here, all four checks."""
    os.environ["AQPC_PACK"] = "1"
    scale = paperscale_args(root)
    rcs = kept(("paperscale", root / "paperscale"), lambda: fail("no paperscale dataset"))
    if rcs != [0, 0]:
        fail(f"paperscale generate and oracle exited {rcs}")
    report_json = root / "paperscale" / "report.json"
    out = tool_output("paperscale run --device cuda", paperscale.main,
                      ["run", *scale, "--device", "cuda", "--json", str(report_json)])
    report = json.loads(report_json.read_text())
    if not report["pass"] or report["oracle"]["points"] != PAPERSCALE_FILES * PAPERSCALE_POINTS:
        fail(f"paperscale: {out}")
    for line in out.strip().splitlines()[1:]:
        print(f"    {line}")
    print(f"    {smi}")


def path_drivers(datasets) -> dict:
    """The JAX CLI's other subcommands and flags, the paper's experiment
    harness and the three tools, each on the card: count-points over LAST
    64M; convert of one LAS file to LAST, LAZER and LAZ; index over a copy
    of LAST 64M; --profile's trace against the launches; --devices; the
    experiments; soak; memcheck at 64 M points; paperscale at 256 M.
    Returns this process's launches and the --profile worker's together."""
    big, box, _, n_points = datasets[0]
    las = datasets[1][0]
    root = big.parents[1]  # the run's directory: the background worker's stand-ins
    smi = smi_line()
    worker = {}  # the --profile worker's launches
    steps = [
        ("count-points", lambda tmp: drivers_count_points(big, n_points)),
        ("convert", lambda tmp: drivers_convert(point_files(las)[0], box, tmp)),
        ("index", lambda tmp: drivers_index(big, box, tmp)),
        ("profile", lambda tmp: worker.update(drivers_profile(big, box, tmp, smi))),
        ("devices", lambda tmp: drivers_devices(big, box)),
        ("experiments", lambda tmp: drivers_experiments(root / "experiments", smi)),
        ("soak", lambda tmp: drivers_soak()),
        ("memcheck", lambda tmp: drivers_memcheck()),
        ("paperscale", lambda tmp: drivers_paperscale(root, smi)),
    ]
    for name, step in steps:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"aqpc_{name}_") as tmp:
            step(Path(tmp))
        print(f"  drivers step {name}: {time.perf_counter() - t0:.1f} s")
    print(f"  launches of the --profile worker: {worker}")
    return {k: n + worker.get(k, 0) for k, n in P.launches.items() if n + worker.get(k, 0)}


# path -> (its function, the kernels it must launch: a tuple is any one of
# them); a function whose kernels launch in other processes returns their
# launches
PATHS = {
    "bbox": (path_bbox, ("bbox_count_multi", "bbox_count_packed")),
    "collect": (path_collect, ("mask_bbox", "mask_bbox_packed", "mask_class", "mask_class_dict",
                               "mask_time", "mask_time_packed", "compact_bits")),
    "class": (path_class, ("class_count_multi", "class_count_words", "class_count_dict")),
    "time": (path_time, ("time_count_multi", "time_count_packed")),
    "probe": (path_probe, ("bbox_probe_acc", "bbox_probe_acc_nomask")),
    "density": (path_density, ("density_leaders", "density_leaders_packed", "density_candidates",
                               "density_candidates_packed", "compact_bits")),
    "resident": (path_resident, ("bbox_count_multi", "class_count_words", "time_count_multi",
                                 "mask_bbox", "mask_class", "mask_time", "compact_bits",
                                 "density_leaders", "density_candidates", "compact_bits_gather")),
    "devices": (path_devices, (
        "bbox_count_multi", "bbox_count_packed", "class_count_dict", "time_count_packed",
        "mask_bbox_packed", "compact_bits", "density_leaders_packed",
        "density_candidates_packed", "class_count_words", "time_count_multi", "mask_time",
        "density_leaders", "density_candidates", "compact_bits_gather")),
    "distributed": (path_distributed, (
        "bbox_count_multi", "bbox_count_packed",
        ("class_count_multi", "class_count_words", "class_count_dict"),
        "time_count_multi", "time_count_packed", ("mask_bbox", "mask_bbox_packed"),
        "compact_bits", ("density_leaders", "density_leaders_packed"),
        ("density_candidates", "density_candidates_packed"))),
    "drivers": (path_drivers, (
        ("bbox_count_multi", "bbox_count_packed"),
        ("class_count_multi", "class_count_words", "class_count_dict"),
        ("time_count_multi", "time_count_packed"), ("mask_bbox", "mask_bbox_packed"),
        "compact_bits", ("density_leaders", "density_leaders_packed"),
        ("density_candidates", "density_candidates_packed"))),
}


def distributed_only() -> int:
    """`chip_smoke.py --distributed-only`: path_distributed over LAST 8 x
    2M points, every check of the path; the last line is the smoke's."""
    phase_env()
    _build.library()
    with tempfile.TemporaryDirectory(prefix="aqpc_smoke_") as tmp:
        big = Path(tmp) / "big"
        synth.write_dataset(big, n_files=8, points_per_file=2_000_000, seed=SEED,
                            formats=("last",), clustered=True, point_format=3)
        t = time.perf_counter()
        launched = path_distributed([(big / "last", None)])
        print(f"phase end to end, distributed: {time.perf_counter() - t:.1f} s")
    print(f"kernel launches in the distributed path: {launched}")
    check_no_jax("at the end of the run")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def stop_processes(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def main() -> int:
    seconds = {}
    t = time.perf_counter()
    phase_env()
    dev = torch.device("cuda", 0)
    seconds["environment"] = time.perf_counter() - t

    launches = {}
    with tempfile.TemporaryDirectory(prefix="aqpc_smoke_") as tmp, \
            contextlib.ExitStack() as stack:
        root = Path(tmp)
        # the datasets are written by two worker processes while the build runs
        writers = start_dataset_writers(root)
        stack.callback(stop_processes, [proc for _, proc in writers])
        t = time.perf_counter()
        phase_build()
        seconds["build (beside the dataset writers)"] = time.perf_counter() - t

        t = time.perf_counter()
        datasets = join_dataset_writers(root, writers)
        seconds["datasets (the writers' rest, after the build)"] = time.perf_counter() - t

        t = time.perf_counter()
        kernels = phase_kernels(dev)  # nothing else runs beside the timings
        seconds["kernels"] = time.perf_counter() - t

        _BACKGROUND["worker"] = background = Background(root)
        stack.callback(background.close)
        for name, (drive, path_kernels) in PATHS.items():
            beside = " (beside the background worker)" if background.running() else ""
            t = time.perf_counter()
            P.reset_launches()
            got = drive(datasets) or dict(P.launches)
            seconds[f"end to end, {name}{beside}"] = time.perf_counter() - t
            print(f"kernel launches in the {name} path: {got}")
            for names in path_kernels:
                names = names if isinstance(names, tuple) else (names,)
                if not any(got.get(kernel, 0) for kernel in names):
                    fail(f"the {name} path never launched {' or '.join(names)}")
                for kernel in names:  # a shared kernel: its first path's
                    launches.setdefault(kernel, got.get(kernel, 0))
        if background.proc.wait(timeout=120) != 0:
            fail(f"the background worker exited {background.proc.returncode}")
    for name, s in seconds.items():
        print(f"phase {name}: {s:.1f} s")
    check_no_jax("at the end of the run")

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
    if sys.argv[1:2] == ["--dist2-worker"]:
        sys.exit(dist2_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--profile-worker"]:
        sys.exit(profile_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--dataset-worker"]:
        sys.exit(dataset_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--background-worker"]:
        sys.exit(background_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--distributed-only"]:
        sys.exit(distributed_only())
    sys.exit(main())

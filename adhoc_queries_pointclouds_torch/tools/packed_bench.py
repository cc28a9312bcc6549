"""Times of the kernels on the persistent tile loop (csrc/collect.cuh) and of
the compaction, for one source tree: the two packed bbox kernels and the two
packed GPS-time kernels at every width, the raw GPS-time mask, the
dictionary class mask, the raw class mask and the ordered compaction.

    python -m adhoc_queries_pointclouds_torch.tools.packed_bench
    python adhoc_queries_pointclouds_torch/tools/packed_bench.py --root OTHER_TREE

bbox_count_packed and mask_bbox_packed at each width triple, then
time_count_packed and mask_time_packed at each width pair (k_hi, k_lo) of
chip_smoke.py's phase 3, then mask_time on raw (hi, lo) words at B and at
B - 8189 (B % 4 == 3, rows off 16-byte boundaries: the scalar loads), then
mask_class_dict at k = 0, 1, 2, 4 and 8 bits a code, then mask_class on u8
class rows at B and at B - 8189 (rows off 16-byte boundaries) and on
chip_smoke.py phase 3's bytes, each beside the same bytes through
mask_class_dict at k = 8 (a u8 row is one byte plane), then
compact_bits with every block skipped (its floor), of two partial blocks
(of K, the others skipped) at hit shares 0.001, 0.05, 0.5 and 0.95 and at
chip_smoke.py phase 3's (0.001 and 0.5), and of all K blocks at the
density path's share (its candidates at the 10 m grid of
density_bench.py, about one a cell), then compact_bits_gather (the
resident density path's compaction that gathers x, y and z) with every
block skipped, with all K blocks at hit shares 0.001, 0.05, 0.5 and 1 and
at chip_smoke.py phase 3's (0, 0.001, 0.5 and 1), after its edges
(gather_edges) against its plain version, then the u8,
word and dictionary
(k = 2) class counts at K = 4 and at a resident dataset's K = 64, each
with one call split by torch.profiler into the launches that fill an
output ("fill_ms") and the rest ("kernel_ms"); --only NAMES (kernel
names, comma-separated) times only their rows. Each runs at the main
path's shape (K = 4 blocks of 2^21 points; the class counts also at 64)
over random words, planes or bytes and a
non-empty range, a code
the block's codes can hold or a class target, on every block (an empty one
skips its block's planes), first against its plain version (exact; the
compaction also against torch.nonzero), then timed with
kernel_timer.KernelTimer (the 50 MB L2 flushed before each run; median and
least of --runs) in both readings: the call (the host's enqueue inside the
window: a busy host lifts single runs, the least shows the card's part)
and the device's work alone. One line per width and kernel: both
readings, the bytes it must move (for the gather, the 32-byte sectors of
x, y and z that its hits touch), and the bound at 3.35 TB/s. The last
line is one JSON object with every number and the card's name and power
limit.

--root imports the package from another checkout of the repository (run the
tool as a file then, not with -m, so that no package is loaded before the
path is set), so two versions of every kernel above, the class mask and
the compaction included, can be timed in turns in one call on one card
(each process builds its tree's kernels). --against
OTHER_TREE --pairs N does that (in_turns.py): N pairs of runs, the first
of a pair alternating between the two trees, then one line per kernel and
width with each tree's median of its runs' medians, its least run and the
pairs the --root tree won, both readings; the last line is one JSON object
with those numbers. It needs a CUDA device.

    python adhoc_queries_pointclouds_torch/tools/packed_bench.py \
        --against .bench_data/parent --pairs 10
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

if __package__:
    from .in_turns import in_turns
    from .kernel_timer import KernelTimer
else:  # run as a file: its own directory is on sys.path, the --root tree is not yet
    from in_turns import in_turns
    from kernel_timer import KernelTimer

K, B = 4, 1 << 21
WIDTHS = [(w, w, w) for w in (0, 4, 12, 20, 28, 32)] + [
    (12, 20, 28), (1, 1, 1), (7, 7, 7), (8, 8, 8), (9, 17, 25), (31, 31, 31)]
TIME_WIDTHS = [(w, w) for w in (0, 4, 12, 20, 28, 32)] + [
    (20, 32), (4, 28), (1, 1), (7, 7), (31, 31), (3, 17), (32, 4), (0, 32), (8, 16), (4, 12),
    (12, 28)]
# the raw time mask's block sizes: 16-byte loads, and the scalar path
RAW_TIME_SIZES = (B, B - 8192 + 3)
DICT_WIDTHS = (0, 1, 2, 4, 8)
# the compaction's hit shares of its two partial blocks, and the density
# path's: the 10 m grid's candidates (154,350 cells, about one a cell) of
# a block of B points
COMPACT_SHARES = (0.001, 0.05, 0.5, 0.95)
SMOKE_SHARES = (0.0, 0.001, 0.5, 1.0)  # chip_smoke.py phase 3's blocks
DENSITY_SHARE = 154_350 / B
# compact_bits_gather's hit shares, of all K blocks
GATHER_SHARES = (0.001, 0.05, 0.5, 1.0)
# csrc/compact_bits.cu kDenseHits: a tile's hits, of its 8192 rows, from
# which it gathers its rows as 16-byte spans
GATHER_DENSE_HITS = 1024
# the class counts' K: the main path's step, and a resident dataset's launch
CLASS_COUNT_KS = (K, 64)
HBM_BYTES_PER_S = 3.35e12
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def gather_edges(seed: int = 0) -> list:
    """[(label, (K, B) bool rows, blocks skipped)]: the edges of
    compact_bits_gather's two paths (csrc/compact_bits.cu), each block given
    an output offset unless skipped. Block 0's 3 hits put every later
    block's output off a 16-byte boundary. Block 1's first tile (8192
    rows, dense) holds, a warp's 1024 rows each: 128 random hits, 127, one
    hit in each 8-row sector, a full span, an empty one and a full one
    again, hits at both ends of every word, and 20 hits in each of 6 words;
    its second tile is full. Block 2 has an empty tile next to a full one.
    Block 6 has a tile with one hit in each sector (GATHER_DENSE_HITS:
    dense) next to one with GATHER_DENSE_HITS - 1 random hits (sparse),
    block 7 a tile of GATHER_DENSE_HITS random hits next to one whose
    first GATHER_DENSE_HITS - 1 rows are hits. Then a partial last mask
    word (B % 32 == 8) in a dense tile, at B % 4 == 0 (the 16-byte path)
    and B % 4 == 1 (the sparse path), with hits in that word."""
    rng = np.random.default_rng(seed)
    span, tile = 1024, 8192
    rows = np.zeros((8, 2 * tile), bool)
    rows[0, :3] = True
    b = rows[1]
    b[rng.choice(span, 128, replace=False)] = True
    b[span + rng.choice(span, 127, replace=False)] = True
    b[2 * span + 8 * np.arange(span // 8) + rng.integers(0, 8, span // 8)] = True
    b[3 * span:4 * span] = True
    b[5 * span:6 * span] = True
    b[6 * span + np.arange(span // 32)[:, None] * 32 + np.array([0, 31])] = True
    for w in (0, 5, 9, 17, 30, 31):  # the word-at-a-time walk
        b[7 * span + 32 * w + rng.choice(32, 20, replace=False)] = True
    b[tile:] = True
    rows[2, tile:] = True
    rows[3, 5] = True
    rows[4] = rng.random(2 * tile) < 0.5
    rows[5, :2] = True
    rows[6, 8 * np.arange(tile // 8) + rng.integers(0, 8, tile // 8)] = True
    rows[6, tile + rng.choice(tile, GATHER_DENSE_HITS - 1, replace=False)] = True
    rows[7, rng.choice(tile, GATHER_DENSE_HITS, replace=False)] = True
    rows[7, tile:tile + GATHER_DENSE_HITS - 1] = True
    cases = [("edges", rows, ()), ("edges, blocks 0 and 3 skipped", rows, (0, 3))]
    for block_size in (2 * tile + 2 * span + 520, 2 * tile + 2 * span + 521):
        r = np.zeros((3, block_size), bool)
        r[0, 0] = True
        r[1] = True
        r[2] = rng.random(block_size) < 0.5
        r[2, -3:] = True
        cases.append((f"partial last word, B % 4 == {block_size % 4}", r, ()))
    return cases


def gather_sector_bytes(rows, skip=()) -> int:
    """The bytes of x, y and z that compact_bits_gather's hits touch in
    32-byte sectors (8 rows of a column) of the (K, B) columns, blocks in
    skip not read; rows: (K, B) bool, on any device."""
    import torch

    keep = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    if skip:
        keep[list(skip)] = False
    k, r = torch.nonzero(rows & keep[:, None], as_tuple=True)
    return 3 * 32 * int(torch.unique((k * rows.shape[1] + r) // 8).numel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose adhoc_queries_pointclouds_torch is timed")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--against", help="second checkout: time both trees in turns")
    ap.add_argument("--pairs", type=int, default=10, help="pairs of runs with --against")
    ap.add_argument("--only", help="comma-separated kernel names: only the rows of their sections")
    args = ap.parse_args(argv)
    if args.against:
        only = ["--only", args.only] if args.only else []
        in_turns(Path(__file__).resolve(), args.root, args.against, args.pairs,
                 ["--runs", str(args.runs), "--seed", str(args.seed), *only],
                 ("kernel", "widths", "bound_ms"), ("device_ms", "ms", "fill_ms", "kernel_ms"))
        return 0
    sys.path.insert(0, args.root)

    import torch

    from adhoc_queries_pointclouds_torch.host import packed_row_width
    from adhoc_queries_pointclouds_torch.ops import compact as C
    from adhoc_queries_pointclouds_torch.ops import predicate as P

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool times kernels on a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    timer = KernelTimer(dev, args.runs)
    nv = torch.full((K,), B, dtype=torch.int32, device=dev)

    print(f"tree {args.root}; card {card}; K={K}, B={B}, median of {args.runs} runs")

    def ranges(widths):
        """Per-block [lo, hi] inside each column's residual space."""
        ends = [((1 << w) - 1, 0) if w < 32 else (I32_MAX, I32_MIN) for w in widths]
        a, c = (torch.stack([torch.randint(bot, top + 1, (K,), device=dev, generator=gen)
                             for top, bot in ends], 1) for _ in range(2))
        return torch.minimum(a, c).to(torch.int32), torch.maximum(a, c).to(torch.int32)

    rows = []
    only = set(args.only.split(",")) if args.only else None

    def want(*kernels) -> bool:
        return only is None or bool(only & set(kernels))

    def timed(kernel, widths, fn, nbytes):
        call_ms, call_min_ms = timer.times(fn)
        device_ms, device_min_ms = timer.times(fn, device=True)
        row = {"kernel": kernel, "widths": widths, "ms": call_ms, "min_ms": call_min_ms,
               "device_ms": device_ms, "device_min_ms": device_min_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        print(f"  {kernel} {widths}: call {call_ms:.4f} ms (least {call_min_ms:.4f}), device "
              f"{device_ms:.4f} ms (least {device_min_ms:.4f}); {nbytes / 1e6:.1f} MB, bound "
              f"{row['bound_ms']:.4f} ms")

    def split(fn, runs: int = 20) -> dict:
        """One call's device time by kernel (torch.profiler, mean of runs
        calls, each after an L2 flush): fill_ms, the launches that fill an
        output (0 where there is none), and kernel_ms, the rest."""
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        fill = kernel = 0.0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if "bitwise_not" in e.key:
                continue
            if "Fill" in e.key:
                fill += us / runs / 1e3
            else:
                kernel += us / runs / 1e3
        print(f"    split (torch.profiler, mean of {runs}): fill {fill:.4f} ms, kernel "
              f"{kernel:.4f} ms")
        return {"fill_ms": fill, "kernel_ms": kernel}

    def check(kernel, widths, count, mask, plain):
        if not torch.equal(count, plain.sum(1, dtype=torch.int32)):
            raise RuntimeError(f"{kernel} count at {widths}: {count.tolist()} is not the plain "
                               f"version's {plain.sum(1).tolist()}")
        check_mask(kernel, widths, mask, plain)

    def check_mask(kernel, widths, mask, plain):
        if not all(torch.equal(g, w) for g, w in zip(mask, P.pack_mask_bits(plain))):
            raise RuntimeError(f"{kernel} mask at {widths} is not the plain version's mask")

    def planes_of(widths):
        return [torch.randint(0, 256, (K, packed_row_width(w, B)), dtype=torch.uint8,
                              device=dev, generator=gen) for w in widths]

    def gather_case(hit, skip, label):
        """compact_bits_gather's operands over the rows hit (blocks in skip
        given -1) and their output's length, the kernel held to its plain
        version."""
        k_rows, block_size = hit.shape
        mask = P.pack_mask_bits(hit)
        offsets, total = [], 0
        for j, c in enumerate(mask.counts.tolist()):
            offsets.append(-1 if j in skip else total)
            total += 0 if j in skip else c
        xyz = [torch.randint(I32_MIN, I32_MAX + 1, (k_rows, block_size), device=dev,
                             generator=gen).to(torch.int32) for _ in range(3)]
        ops = (mask.bits, mask.chunks, torch.tensor(offsets, dtype=torch.int64, device=dev),
               total, block_size, *xyz)
        got = C.compact_bits_gather(*ops)
        if not all(torch.equal(g, w) for g, w in zip(got, C.compact_bits_gather_plain(*ops))):
            raise RuntimeError(f"compact_bits_gather, {label}: not the plain version's output")
        return ops, total

    for widths in WIDTHS if want("bbox_count_packed", "mask_bbox_packed") else ():
        lo, hi = ranges(widths)
        ops = (*planes_of(widths), lo, hi, nv, widths, B)
        check("bbox", widths, P.bbox_count_packed_kernel(*ops), P.bbox_mask_bits_packed(*ops),
              P.bbox_mask_packed_multi(*ops))
        count_bytes = sum(widths) / 8 * K * B
        timed("bbox_count_packed", widths, lambda: P.bbox_count_packed_kernel(*ops), count_bytes)
        timed("mask_bbox_packed", widths, lambda: P.bbox_mask_bits_packed(*ops),
              count_bytes + K * B / 8)
    for widths in TIME_WIDTHS if want("time_count_packed", "mask_time_packed") else ():
        lo, hi = ranges(widths)
        qs = torch.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]], 1)
        # inside residual space with lo <= hi on each column, [start, end)
        # is empty where both words are equal: take the whole range there
        empty = (qs[:, 0] == qs[:, 2]) & (qs[:, 1] == qs[:, 3])
        qs[empty] = torch.tensor([I32_MIN, I32_MIN, I32_MAX, I32_MAX], dtype=torch.int32,
                                 device=dev)
        ops = (*planes_of(widths), qs, nv, widths, B)
        check("time", widths, P.time_count_packed_kernel(*ops), P.time_mask_bits_packed(*ops),
              P.time_mask_packed_multi(*ops))
        count_bytes = sum(widths) / 8 * K * B
        timed("time_count_packed", widths, lambda: P.time_count_packed_kernel(*ops), count_bytes)
        timed("mask_time_packed", widths, lambda: P.time_mask_bits_packed(*ops),
              count_bytes + K * B / 8)
    for bs in RAW_TIME_SIZES if want("mask_time") else ():
        # rows off 16-byte boundaries below B: the first K * bs words as (K, bs)
        ths, tls = (torch.randint(I32_MIN, I32_MAX + 1, (K * B,), device=dev, generator=gen)
                    .to(torch.int32)[:K * bs].view(K, bs) for _ in range(2))
        lo, hi = ranges((32,))  # [(lo, INT32_MIN), (hi, INT32_MAX)): never empty
        qs = torch.cat([lo, torch.full_like(lo, I32_MIN), hi, torch.full_like(lo, I32_MAX)], 1)
        nv_raw = torch.full((K,), bs, dtype=torch.int32, device=dev)
        ops = (ths, tls, qs, nv_raw)
        check_mask("mask_time", bs, P.time_mask_bits(*ops), P.time_mask_multi(*ops))
        timed("mask_time", f"B={bs}", lambda: P.time_mask_bits(*ops), 8 * K * bs + K * bs / 8)
    for k in DICT_WIDTHS if want("mask_class_dict") else ():
        cp = planes_of((k,))[0]
        codes = torch.randint(0, 1 << k, (K,), dtype=torch.int32, device=dev, generator=gen)
        ops = (cp, codes, nv, k, B)
        check_mask("mask_class_dict", k, P.class_mask_bits_dict(*ops),
                   P.class_mask_dict_multi(*ops))
        timed("mask_class_dict", (k,), lambda: P.class_mask_bits_dict(*ops),
              k / 8 * K * B + K * B / 8)
    for bs in RAW_TIME_SIZES if want("mask_class", "mask_class_dict") else ():
        # rows off 16-byte boundaries below B: the first K * bs bytes as (K, bs)
        cls = torch.randint(0, 256, (K * B,), dtype=torch.uint8, device=dev,
                            generator=gen)[:K * bs].view(K, bs)
        targets = torch.randint(0, 256, (K,), dtype=torch.int32, device=dev, generator=gen)
        nv_cls = torch.full((K,), bs, dtype=torch.int32, device=dev)
        plain = P.class_mask_multi(cls, targets, nv_cls)
        check_mask("mask_class", bs, P.class_mask_bits(cls, targets, nv_cls), plain)
        check_mask("mask_class_dict", bs, P.class_mask_bits_dict(cls, targets, nv_cls, 8, bs),
                   plain)
        nbytes = K * bs + K * bs / 8
        timed("mask_class", f"B={bs}", lambda: P.class_mask_bits(cls, targets, nv_cls), nbytes)
        timed("mask_class_dict", f"k=8, class bytes, B={bs}",
              lambda: P.class_mask_bits_dict(cls, targets, nv_cls, 8, bs), nbytes)
    if want("mask_class", "mask_class_dict"):
        # chip_smoke.py phase 3's bytes: class 6 at its blocks' hit shares, 7..255
        # elsewhere, and target 6 in every block
        hit = torch.rand((K, B), device=dev, generator=gen) < torch.tensor(SMOKE_SHARES,
                                                                            device=dev)[:, None]
        cls = torch.where(hit, 6, torch.randint(7, 256, (K, B), device=dev, generator=gen))
        cls = cls.to(torch.uint8)
        targets = torch.full((K,), 6, dtype=torch.int32, device=dev)
        plain = P.class_mask_multi(cls, targets, nv)
        check_mask("mask_class", "smoke", P.class_mask_bits(cls, targets, nv), plain)
        check_mask("mask_class_dict", "smoke", P.class_mask_bits_dict(cls, targets, nv, 8, B),
                   plain)
        timed("mask_class", "smoke", lambda: P.class_mask_bits(cls, targets, nv), K * B * 9 / 8)
        timed("mask_class_dict", "k=8, class bytes, smoke",
              lambda: P.class_mask_bits_dict(cls, targets, nv, 8, B), K * B * 9 / 8)
    share_cases = (0.0, *COMPACT_SHARES, SMOKE_SHARES, DENSITY_SHARE)
    for share in share_cases if want("compact_bits") else ():
        density = share == DENSITY_SHARE
        shares = torch.tensor(share, device=dev)
        hit = torch.rand((K, B), device=dev, generator=gen) < shares.reshape(-1, 1)
        if not density:  # block 0 has no hits and block 3 is full: both skipped
            hit[0], hit[3] = False, True
        mask = P.pack_mask_bits(hit)
        counts = mask.counts.tolist()
        partial = [j for j in range(K) if 0 < counts[j] < B]
        offsets, total = [-1] * K, 0
        for j in partial:
            offsets[j], total = total, total + counts[j]
        off = torch.tensor(offsets, dtype=torch.int64, device=dev)
        got = C.compact_bits(mask.bits, mask.chunks, off, total, B)
        if not torch.equal(got, torch.nonzero(hit[partial])[:, 1].to(torch.int32)):
            raise RuntimeError(f"compact_bits at share {share}: the rows differ from "
                               f"torch.nonzero's")
        label = ("density 10 m" if density else "smoke" if share == SMOKE_SHARES
                 else "every block skipped" if share == 0.0 else f"share {share}")
        timed("compact_bits", f"{label}, {total} hits of {len(partial)} blocks",
              lambda: C.compact_bits(mask.bits, mask.chunks, off, total, B),
              len(partial) * B / 8 + 4 * total)
    if want("compact_bits_gather"):
        # the edges against the plain version, then every block skipped and
        # all K blocks at each share, every block given an offset
        for label, edge, skip in gather_edges(args.seed):
            hit = torch.from_numpy(edge).to(dev)
            gather_case(hit, skip, label)
        for share in (None, *GATHER_SHARES, SMOKE_SHARES):
            shares = torch.tensor(0.5 if share is None else share, device=dev)
            hit = torch.rand((K, B), device=dev, generator=gen) < shares.reshape(-1, 1)
            skip = range(K) if share is None else ()
            ops, total = gather_case(hit, skip, f"share {share}")
            label = ("every block skipped" if share is None else "smoke" if share == SMOKE_SHARES
                     else f"share {share}")
            mask_bytes = 0 if share is None else K * B / 8
            timed("compact_bits_gather", f"{label}, {total} hits",
                  lambda: C.compact_bits_gather(*ops),
                  mask_bytes + gather_sector_bytes(hit, skip) + 16 * total)
    # the class counts (u8, words, dictionary at k = 2) at the main path's K
    # and at a resident dataset's, a target or code in every block, each
    # with one call split into the profiler's kernels: the output's fill
    # and the kernel
    for k_rows in CLASS_COUNT_KS if want("class_count_multi", "class_count_words",
                                         "class_count_dict") else ():
        nv_k = torch.full((k_rows,), B, dtype=torch.int32, device=dev)
        cls = torch.randint(0, 256, (k_rows, B), dtype=torch.uint8, device=dev, generator=gen)
        targets = torch.randint(0, 256, (k_rows,), dtype=torch.int32, device=dev, generator=gen)
        want = P.class_count_multi(cls, targets, nv_k)
        words = cls.view(torch.int32)
        for kernel, fn in (("class_count_multi", lambda: P.class_count_multi_kernel(cls, targets,
                                                                                    nv_k)),
                           ("class_count_words", lambda: P.class_count_words_kernel(words, targets,
                                                                                    nv_k))):
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{kernel} at K={k_rows} is not the plain version's count")
            timed(kernel, f"K={k_rows}", fn, k_rows * B)
            rows[-1].update(split(fn))
        del cls, words
        cp = torch.randint(0, 256, (k_rows, packed_row_width(2, B)), dtype=torch.uint8,
                           device=dev, generator=gen)
        codes = torch.arange(k_rows, dtype=torch.int32, device=dev) % 4
        fn = lambda: P.class_count_dict_kernel(cp, codes, nv_k, 2, B)  # noqa: E731
        if not torch.equal(fn(), P.class_count_dict_multi(cp, codes, nv_k, 2, B)):
            raise RuntimeError(f"class_count_dict at K={k_rows} is not the plain version's count")
        timed("class_count_dict", f"k=2, K={k_rows}", fn, k_rows * B / 4)
        rows[-1].update(split(fn))
        del cp
    print(json.dumps({"tree": args.root, "card": card, "runs": args.runs, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times of the two packed bbox kernels at every width, for one source tree.

    python -m adhoc_queries_pointclouds_torch.tools.packed_bbox_bench
    python adhoc_queries_pointclouds_torch/tools/packed_bbox_bench.py --root OTHER_TREE

bbox_count_packed and mask_bbox_packed run at the main path's shape (K = 4
full blocks of 2^21 points) over random planes at each width triple, first
against their plain versions (exact), then timed: CUDA events around each
launch, the 50 MB L2 flushed before it, median and least of --runs (the
wrapper's launches are timed with the kernel, so a busy host lifts single
runs and at times the median; the least run shows the card's part). One
line per width: both times, the bytes each must move, and the bound at
3.35 TB/s.
The last line is one JSON object with every number and the card's name and
power limit.

--root imports the package from another checkout of the repository (run the
tool as a file then, not with -m, so that no package is loaded before the
path is set), so two versions of the kernels can be timed in turns in one
call on one card (each process builds its tree's kernels): run it for
the parent, the change, the change and the parent, and compare the medians.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

K, B = 4, 1 << 21
WIDTHS = [(w, w, w) for w in (0, 4, 12, 20, 28, 32)] + [
    (12, 20, 28), (1, 1, 1), (7, 7, 7), (8, 8, 8), (9, 17, 25), (31, 31, 31)]
HBM_BYTES_PER_S = 3.35e12
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose adhoc_queries_pointclouds_torch is timed")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch

    from adhoc_queries_pointclouds_torch.host import packed_row_width
    from adhoc_queries_pointclouds_torch.ops import predicate as P

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool times kernels on a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    nv = torch.full((K,), B, dtype=torch.int32, device=dev)

    def ms(fn) -> tuple[float, float]:
        fn()
        times = []
        for _ in range(args.runs):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times), min(times)

    print(f"tree {args.root}; card {card}; K={K}, B={B}, median of {args.runs} runs")
    rows = []
    for widths in WIDTHS:
        planes = [torch.randint(0, 256, (K, packed_row_width(w, B)), dtype=torch.uint8,
                                device=dev, generator=gen) for w in widths]
        ends = [((1 << w) - 1, 0) if w < 32 else (I32_MAX, I32_MIN) for w in widths]
        a, c = (torch.stack([torch.randint(bot, top + 1, (K,), device=dev, generator=gen)
                             for top, bot in ends], 1) for _ in range(2))
        lo, hi = torch.minimum(a, c).to(torch.int32), torch.maximum(a, c).to(torch.int32)
        ops = (*planes, lo, hi, nv, widths, B)
        want = P.bbox_mask_packed_multi(*ops)
        got = P.bbox_count_packed_kernel(*ops)
        if not torch.equal(got, want.sum(1, dtype=torch.int32)):
            raise RuntimeError(f"bbox_count_packed at {widths}: {got.tolist()} is not the plain "
                               f"version's {want.sum(1).tolist()}")
        mask = P.bbox_mask_bits_packed(*ops)
        if not all(torch.equal(g, w) for g, w in zip(mask, P.pack_mask_bits(want))):
            raise RuntimeError(f"mask_bbox_packed at {widths} is not the plain version's mask")
        del want
        count_bytes = sum(widths) / 8 * K * B
        mask_bytes = count_bytes + K * B / 8
        count_ms, count_min_ms = ms(lambda: P.bbox_count_packed_kernel(*ops))
        mask_ms, mask_min_ms = ms(lambda: P.bbox_mask_bits_packed(*ops))
        row = {
            "widths": widths,
            "count_ms": count_ms, "count_min_ms": count_min_ms,
            "mask_ms": mask_ms, "mask_min_ms": mask_min_ms,
            "count_bound_ms": count_bytes / HBM_BYTES_PER_S * 1e3,
            "mask_bound_ms": mask_bytes / HBM_BYTES_PER_S * 1e3,
        }
        rows.append(row)
        print(f"  widths {widths}: count {count_ms:.4f} ms (least {count_min_ms:.4f}; "
              f"{count_bytes / 1e6:.1f} MB, bound {row['count_bound_ms']:.4f} ms), "
              f"mask {mask_ms:.4f} ms (least {mask_min_ms:.4f}; {mask_bytes / 1e6:.1f} MB, "
              f"bound {row['mask_bound_ms']:.4f} ms)")
    print(json.dumps({"tree": args.root, "card": card, "runs": args.runs, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How many of a process's kernel launches a torch.profiler trace holds,
over the process's life.

Each profile records N launches of bbox_count_multi (K=4 blocks of 2^21
points) through the CLI's --profile (cli.profiled) and counts, in the
Chrome trace it writes, the kernel events of that kernel and the runtime
launch events; a launch whose kernel event is missing is reported by its
position. The profiles run in a fresh process, then ROUNDS times after
3,000 unprofiled launches and IDLE_S seconds of idling, each in three
forms: launches 10 ms apart, back to back, and with 0.5 s of idle inside
the profiler's window before and after them. One JSON line a profile: its
age in the process, the kernel events against the launches, and the least
and largest kernel timestamp less its launch's (us). About two minutes.

    python -m adhoc_queries_pointclouds_torch.tools.profile_check

Needs a CUDA device; nothing runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from ..cli import profile_events, profiled
from ..ops import predicate as P
from ..parallel.comm import require_device

KERNEL = "bbox_count_multi_kernel"
N = 20  # launches a profile
ROUNDS = 3
IDLE_S = 30.0


def profile_launches(fn, n: int, gap: float, pad: float) -> dict:
    """n launches of fn under the CLI's --profile (CPU and CUDA activity)."""

    def window():
        time.sleep(pad)
        for _ in range(n):
            fn()
            if gap:
                torch.cuda.synchronize()
                time.sleep(gap)
        torch.cuda.synchronize()
        time.sleep(pad)

    with tempfile.TemporaryDirectory() as d:
        profiled(window, "cuda", Path(d))
        kernels = {e["args"]["correlation"]: e for e in profile_events(d, "kernel")
                   if KERNEL in e["name"]}
        launches = [e for e in profile_events(d, "cuda_runtime") if "aunch" in e["name"]]
    # each call launches the same kernels in the same order (the output's
    # fill, the bounds' join, then the count): its launches are the last of
    # each call's runtime launch events
    per_call = len(launches) // n
    if not per_call or len(launches) % n:
        raise RuntimeError(f"{len(launches)} runtime launch events for {n} calls")
    ours = launches[per_call - 1::per_call]
    offsets = [kernels[e["args"]["correlation"]]["ts"] - e["ts"] for e in ours
               if e["args"]["correlation"] in kernels]
    return {"launches": n, "kernel_events": len(kernels), "runtime_launch_events": len(launches),
            "missing_positions": [i for i, e in enumerate(ours)
                                  if e["args"]["correlation"] not in kernels],
            "kernel_less_launch_us": [min(offsets), max(offsets)] if offsets else None}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="profile_check", description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    dev = require_device("cuda")
    k, b = 4, 1 << 21
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xs, ys, zs = (torch.randint(-2**30, 2**30, (k, b), generator=gen, device=dev,
                                dtype=torch.int32) for _ in range(3))
    lo = torch.full((k, 3), -2**29, dtype=torch.int32, device=dev)
    hi = -lo
    nv = torch.full((k,), b, dtype=torch.int32, device=dev)

    def fn():
        return P.bbox_count_multi_kernel(xs, ys, zs, lo, hi, nv)

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for r in range(ROUNDS + 1):
        if r:
            for _ in range(3000):
                fn()
            torch.cuda.synchronize()
            time.sleep(IDLE_S)
        for form, gap, pad in (("10 ms apart", 0.01, 0.0), ("back to back", 0.0, 0.0),
                               ("0.5 s idle before and after", 0.01, 0.5)):
            print(json.dumps({"age_s": round(time.time() - t0, 1), "form": form,
                              "card": torch.cuda.get_device_name(dev),
                              **profile_launches(fn, N, gap, pad)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

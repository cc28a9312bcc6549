"""Multi-process queries of the port: every process reads its share of the
file manifest, runs the engine on it over its own shards, and the
processes join their counts and density winners over torch.distributed.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/distributed.py,
with its function names. The reference's only parallelism is a per-file
fan-out on threads (main.rs:146-183); here each process takes every P-th
file (shard_manifest) and `engine.run_query` runs unchanged on it with
DistStepComm, so the decode-ahead feeder, both transports and sidecar-index
pruning run as they do in one process.

Each process drives the shards of process_devices(device, n), the port's
counterpart of jax.local_devices() under JAX's global_mesh(): each step's
rows split over them as parallel/mesh.py splits them in one process, a
process's shard counts are summed in Python ints, and its hits and density
candidates are taken in shard order, which is file order. With --device
cuda, process I's n shards are the cards (I * n + j) % the card count, for
j < n: with n = 1, card I % the card count; with P * n cards or more, the
processes' cards are disjoint; past that, cards repeat across and within
processes (a card may hold several shards, parallel/mesh.py).
global_device_count() is the group's shard total, the counterpart of
global_mesh().devices.size.

Two things differ from the JAX module:

- The collectives run on the gloo backend over host tensors, whatever the
  device. Every value they carry is a host value (a count, a maximum, the
  int32 wire rows of density winners), and NCCL refuses two ranks on one
  card, which is how several processes share one GPU.
- There is no lockstep. JAX agrees on the block size, the step count, the
  packed widths and a fixed step shape because every host compiles and
  dispatches the same SPMD program over the global mesh. Here each process
  launches its own kernels on its own shards, and no collective sits
  inside a step: a process with an empty shard runs no step, and the
  processes meet only in the final reductions. So each process's device
  total is its own, and finish_total reduces it with the host total.

Hit payloads never cross processes: a collect's LAS dumps land under
host{i}/ of the output directory, and a global-scope density query gathers
28-byte wire rows of its winners, never their points.

Bring a group up with initialize(coordinator, num_processes, process_id)
in every process (the CLI's --distributed --coordinator HOST:PORT
--num-processes N --process-id I [--devices n]); without one, every call
here is the one-process engine over its shards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..engine import DEFAULT_BLOCK_SIZE, QueryResult, discover_files, run_query
from ..formats import open_point_cloud
from ..models.query import QueryPlan
from ..sinks import HitEmitter, concat_hits, gather_hits
from ..utils.aabb import AABB
from ..utils.timing import StageTimer
from .comm import LocalStepComm, require_device
from .mesh import local_devices

# a collective that waits longer than this for a peer fails the run
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Bring up the gloo process group (no-op if it is up already, or with
    no coordinator: a single process). Nothing on a machine tells a process
    of its peers, so num_processes and process_id are required with a
    coordinator."""
    if dist.is_initialized() or coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout,
    )


def shutdown() -> None:
    """Leave the process group (no-op without one), so that its threads
    end before the interpreter does: a process that exits with the group
    up can abort at exit ("terminate called without an active
    exception") after its last collective."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def card_layout(pid: int, cards: int, n: int) -> list[int]:
    """The card indices of process pid's n shards on a host of `cards`
    cards: (pid * n + j) % cards for j < n."""
    return [(pid * n + j) % cards for j in range(n)]


def process_devices(device, n: int | None = None) -> list[torch.device]:
    """This process's shards, one torch.device each (the counterpart of
    jax.local_devices() under global_mesh()).

    "cuda": the cards card_layout(process_index(), device_count, n or 1).
    "cpu" (n CPU shards, one without n) and "cuda:I" (that card alone, n 1
    or None) are local_devices'. "cuda" without CUDA raises, and so does n
    below 1."""
    device = require_device(device)
    if device.type == "cpu" or device.index is not None or (n is not None and n < 1):
        return local_devices(device, n)
    return [torch.device("cuda", i)
            for i in card_layout(process_index(), torch.cuda.device_count(), n or 1)]


def process_device(device) -> torch.device:
    """This process's one device (process_devices at n = 1): a CUDA device
    with no index is card process_index() % device_count, so that
    processes beyond the card count share the cards."""
    return process_devices(device)[0]


def global_device_count(devices) -> int:
    """The group's shard total: the sum of every process's len(devices)
    (the counterpart of global_mesh().devices.size)."""
    return _allreduce_sum(len(devices))


def _shards(device, devices) -> list:
    """The shards a call runs on: devices, one entry a shard, or a lone
    device as one shard."""
    if devices:
        return list(devices)
    if device is None:
        raise ValueError("a distributed query needs device= or devices=")
    return [device]


def shard_manifest(files: list[Path]) -> list[Path]:
    """This process's slice of the file manifest (round-robin by process)."""
    pid, n = process_index(), process_count()
    return [f for i, f in enumerate(files) if i % n == pid]


def _allreduce(value: int, op) -> int:
    if process_count() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=op)
    return int(t)


def _allreduce_max(value: int) -> int:
    return _allreduce(value, dist.ReduceOp.MAX)


def _allreduce_sum(value: int) -> int:
    return _allreduce(value, dist.ReduceOp.SUM)


class DistStepComm(LocalStepComm):
    """Multi-process step-communication strategy for engine.run_query (the
    contract is parallel/comm.py's), over this process's devices, one a
    shard, as LocalStepComm takes them. Steps, blocks and widths are each
    process's own (see the module docstring): only the count is reduced.
    No step spans processes, so finish_total reduces the device total with
    the host total (JAX's psum made its device total global already and
    reduced the host total only)."""

    # an empty shard is not an error: the process still joins the reductions
    is_local = False

    def reduce_sum(self, value: int) -> int:
        return _allreduce_sum(value)


def _sharded_plan(input_path, plan: QueryPlan, parity_quirk: bool, output_dir: Path | None):
    files = shard_manifest(discover_files(input_path))
    if parity_quirk and not plan.parity_quirk:
        plan = dataclasses.replace(plan, parity_quirk=True)
    if output_dir is not None and plan.output_dir != output_dir:
        plan = dataclasses.replace(plan, output_dir=Path(output_dir))
    return files, plan


def distributed_query(
    input_path,
    plan: QueryPlan,
    *,
    device=None,
    devices=None,
    block_size: int = DEFAULT_BLOCK_SIZE,
    parity_quirk: bool = False,
    use_index: bool = True,
    output_dir: Path | None = None,
    print_stream=None,
    keep_hits: bool = False,
):
    """Run one plan over every process's manifest shard through the engine
    (run_query + DistStepComm) on this process's shards: devices, one entry
    a shard (process_devices), or a lone device as one shard. Returns the
    engine's QueryResult: its match_count is the global total; hits and
    output_files are this process's (with several processes its LAS dumps
    land under host{i}/, so a shared output directory never collides).

    Density plans go to distributed_density, which resolves winners across
    processes and writes them itself: the result's hits and output_files
    are empty, and its files_searched and total_file_bytes are global. On
    the other paths those two fields are this process's, as run_query
    reports them."""
    files, plan = _sharded_plan(input_path, plan, parity_quirk, output_dir)
    if plan.density is not None:
        t0 = time.perf_counter()
        count = distributed_density(input_path, plan, device=device, devices=devices,
                                    block_size=block_size)
        return QueryResult(
            match_count=count, hits=[], output_files=[],
            total_file_bytes=_allreduce_sum(sum(f.stat().st_size for f in files)),
            elapsed_seconds=time.perf_counter() - t0,
            timer=StageTimer(),
            files_searched=_allreduce_sum(len(files)),
        )
    if plan.output_dir is not None and process_count() > 1:
        plan = dataclasses.replace(plan, output_dir=_host_output_dir(plan))
    shards = _shards(device, devices)
    return run_query(
        files, plan, device=shards[0], devices=shards, block_size=block_size,
        use_index=use_index, print_stream=print_stream, keep_hits=keep_hits,
        comm=DistStepComm(shards),
    )


def distributed_count(input_path, plan: QueryPlan, *, device=None, devices=None,
                      block_size: int = DEFAULT_BLOCK_SIZE, parity_quirk: bool = False) -> int:
    """bbox, class or GPS-time count over every process's file shard."""
    return distributed_query(
        input_path, plan, device=device, devices=devices, block_size=block_size,
        parity_quirk=parity_quirk,
    ).match_count


# the JAX module's round-1 name
distributed_bbox_count = distributed_count


def distributed_collect(
    input_path,
    plan: QueryPlan,
    *,
    device=None,
    devices=None,
    block_size: int = DEFAULT_BLOCK_SIZE,
    parity_quirk: bool = False,
    output_dir: Path | None = None,
    print_stream=None,
    keep_hits: bool = False,
):
    """Collect over every process's file shard: each process gathers and
    dumps the hits of its own files (the reference's per-file collection,
    main.rs:153-161, lifted to processes). Returns (global match count,
    this process's QueryResult: its output_files and hits are its own)."""
    res = distributed_query(
        input_path, plan, device=device, devices=devices, block_size=block_size,
        parity_quirk=parity_quirk, output_dir=output_dir, print_stream=print_stream,
        keep_hits=keep_hits,
    )
    return res.match_count, res


def _allgather_slab_bytes() -> int:
    """Gathered-buffer budget per slab (AQPC_ALLGATHER_SLAB_KB, default
    64 MB: peak gather memory stays about this whatever the winner count)."""
    return int(os.environ.get("AQPC_ALLGATHER_SLAB_KB", str(64 << 10))) << 10


def _allgather_i32_rows(rows: np.ndarray, slab_bytes: int | None = None) -> np.ndarray:
    """All-gather an (n, W) int32 matrix across processes -> (sum n, W).

    Rows travel as int32 words, as in the JAX module, so the wire format is
    the same. Each process pads its slab to the same shape (every
    all_gather takes equal shapes), with its row count in slot 0. The row
    space [0, cross-process max n) is walked in slabs whose gathered buffer
    stays within slab_bytes, so peak memory follows the budget and not
    processes x the largest n."""
    n_proc = process_count()
    if n_proc == 1:
        return rows
    W = rows.shape[1]
    maxn = max(_allreduce_max(len(rows)), 1)
    if slab_bytes is None:
        slab_bytes = _allgather_slab_bytes()
    slab_rows = min(max(1, slab_bytes // (n_proc * W * 4)), maxn)
    rows = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
    local = torch.zeros(1 + slab_rows * W, dtype=torch.int32)
    gathered = [torch.empty_like(local) for _ in range(n_proc)]
    parts = []
    for s0 in range(0, maxn, slab_rows):
        cnt = int(np.clip(len(rows) - s0, 0, slab_rows))
        local[0] = cnt
        local[1:1 + cnt * W] = rows[s0:s0 + cnt].reshape(-1)
        local[1 + cnt * W:] = 0
        dist.all_gather(gathered, local)
        parts += [g[1:1 + int(g[0]) * W].numpy().reshape(-1, W).copy()
                  for g in gathered if int(g[0]) > 0]
    if not parts:
        return np.empty((0, W), np.int32)
    return np.concatenate(parts, axis=0)


def _allgather_keys(keys: np.ndarray) -> np.ndarray:
    """Union of winner cell keys across processes (u64, order irrelevant),
    on the slabbed int32-word gather: a count header per process rather
    than an in-band sentinel, which a legitimate all-ones key could
    match."""
    if process_count() == 1:
        return keys
    rows = np.ascontiguousarray(keys).view(np.int32).reshape(-1, 2)
    return _allgather_i32_rows(rows).ravel().view(np.uint64)


def _host_output_dir(plan: QueryPlan) -> Path | None:
    """This process's output subdirectory when there are several: each
    process names its LAS dumps matching_points_{i} by its own count, so a
    shared directory would collide."""
    if plan.output_dir is None or process_count() == 1:
        return plan.output_dir
    out = Path(plan.output_dir) / f"host{process_index()}"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _winner_rows_i32(state, local_to_global) -> np.ndarray:
    """WINNER_DTYPE state -> (n, 7) int32 wire rows:
    key (2 words) | d2 bit pattern (2) | global file rank (1) | gidx (2)."""
    n = 0 if state is None else len(state)
    rows = np.zeros((n, 7), np.int32)
    if n:
        rows[:, 0:2] = np.ascontiguousarray(state["key"]).view(np.int32).reshape(n, 2)
        rows[:, 2:4] = np.ascontiguousarray(state["d2"]).view(np.int32).reshape(n, 2)
        rows[:, 4] = local_to_global(state["file_idx"].astype(np.int64)).astype(np.int32)
        rows[:, 5:7] = np.ascontiguousarray(
            state["gidx"].astype(np.int64)
        ).view(np.int32).reshape(n, 2)
    return rows


def distributed_density(input_path, plan: QueryPlan, *, device=None, devices=None,
                        block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Max-density sampled count (and winner write-back) over every
    process's file shard.

    Each process runs the one-process density pipeline over its file
    shard on its shards (devices, or a lone device), against one shared
    grid: the query box, or with no box the union of ALL files' headers.

    scope='file': winner sets are per file and no file spans processes, so
    each process writes its own files' winners (under host{i}/) and only
    the count is reduced.

    scope='global': winners are resolved per cell key across processes by
    an all-gather of (key, d2 bits, global file rank, gidx) wire rows. The
    champion of a key is the least (d2, file rank, gidx), which is the
    one-process engine's tie rule (WinnerAccum keeps the least (d2,
    file_seq, gidx)) as long as local file j is global file j * n + pid,
    as shard_manifest makes it. Each process then writes only the winners
    it owns, read from its own files (the reference's GridSampledCollector
    and dump, collect_points.rs:100-127, lifted to processes)."""
    all_files = discover_files(input_path)
    my_files = shard_manifest(all_files)
    nproc = process_count()
    pid = process_index()

    # the shared grid: the query box, or the union of every file's header
    # (headers are cheap: every process reads them all)
    if plan.bounds is not None:
        grid_bounds = None  # run_query derives it from the box
    else:
        grid_bounds = AABB.empty()
        for f in all_files:
            r = open_point_cloud(f)
            grid_bounds = grid_bounds.union(r.header.bounds)
            r.close()

    scope = plan.density.scope
    host_out = _host_output_dir(plan)
    run_plan = plan
    if scope == "file":
        if host_out != plan.output_dir:
            run_plan = dataclasses.replace(plan, output_dir=host_out)
    elif nproc > 1 and plan.output_dir is not None:
        # global scope over several processes: no local (unresolved) dump;
        # the resolved winners are written below
        run_plan = dataclasses.replace(plan, output_dir=None)

    shards = _shards(device, devices)
    state_out: dict = {}
    if my_files:
        run_query(
            my_files, run_plan, device=shards[0], devices=shards, block_size=block_size,
            density_grid_bounds=grid_bounds, density_state_out=state_out,
        )
    if scope == "file":
        local = sum(len(s) for s in state_out.get("file", {}).values() if s is not None)
        return _allreduce_sum(local)

    g = state_out.get("global")
    if nproc == 1:
        # one process: run_query wrote the merged output already
        return 0 if g is None else len(g)

    # round-robin shard: local file j is global manifest entry j * nproc + pid
    rows = _winner_rows_i32(g, lambda j: j * nproc + pid)
    allrows = _allgather_i32_rows(rows)
    if len(allrows) == 0:
        return 0
    keys = np.ascontiguousarray(allrows[:, 0:2]).view(np.uint64).ravel()
    d2 = np.ascontiguousarray(allrows[:, 2:4]).view(np.float64).ravel()
    rank = allrows[:, 4].astype(np.int64)
    gidx = np.ascontiguousarray(allrows[:, 5:7]).view(np.int64).ravel()
    # the champion of a key: the least (d2, rank, gidx)
    order = np.lexsort((gidx, rank, d2, keys))
    k_sorted = keys[order]
    first = np.ones(len(k_sorted), bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    win = order[first]
    count = int(first.sum())

    if plan.output_dir is not None:
        mine = win[rank[win] % nproc == pid]
        my_readers = [open_point_cloud(f) for f in my_files]
        try:
            parts = []
            for r_rank in np.unique(rank[mine]):
                j = int(r_rank) // nproc  # local file index
                sel = mine[rank[mine] == r_rank]
                parts.append(gather_hits(my_readers[j], np.sort(gidx[sel]), j))
            emitter = HitEmitter(my_readers, output_dir=host_out)
            emitter.emit_hits(-1, concat_hits(parts))
            emitter.finalize_file(-1)
        finally:
            for r in my_readers:
                r.close()
    return count

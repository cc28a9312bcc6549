"""Several devices in one process: the port's counterpart of
adhoc_queries_pointclouds_tpu/parallel/mesh.py.

JAX meshes the process's devices (make_mesh, mesh.py:35-47) and runs each
engine step under shard_map with P("d"): the step's rows are split into d
contiguous groups, one a device, and the per-device counts meet in a psum.
Here the mesh is a list of torch devices, one a shard. A step's numpy
operands are padded to a multiple of d rows (padding rows have n_valid 0, so
they match nothing) and split into d contiguous groups; group j is copied to
device j and launched there, and the host combines the shards' results:
counts summed in Python ints, hit indices and density candidates
concatenated in shard order, which is the step's row order and so file
order. No kernel spans devices.

A list may name a device twice: its shards then share that device's
current stream, and their launches run in order.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import require_device


def local_devices(device, n: int | None = None) -> list[torch.device]:
    """The devices a query runs on, one a shard.

    device "cuda": every local card, or the first n (more than the cards
    raise); "cuda:I": that card alone (n 1 or None); "cpu": one CPU shard,
    or n of them (the tests' counterpart of JAX's virtual host devices).
    "cuda" without CUDA raises; n below 1 raises."""
    device = require_device(device)
    if n is not None and n < 1:
        raise ValueError(f"--devices {n}: a query needs at least one device")
    if device.type == "cpu":
        return [device] * (n or 1)
    if device.index is not None:
        if n not in (None, 1):
            raise ValueError(f"--devices {n}: {device} names one card")
        return [device]
    cards = torch.cuda.device_count()
    if n is not None and n > cards:
        raise ValueError(f"--devices {n}: this machine has {cards} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n or cards)]


def step_rows(n_batch: int, d: int) -> int:
    """The rows of a step of n_batch blocks over d shards: rounded up to a
    multiple of d (JAX LocalStepComm.step_rows, comm.py:56-60)."""
    return -(-n_batch // d) * d


def split_rows(arrays: tuple, d: int) -> list[tuple]:
    """A step's (rows, ...) numpy operands, rows a multiple of d -> d tuples
    of contiguous row groups (views), the j-th for shard j."""
    return [tuple(a) for a in zip(*(np.split(a, d) for a in arrays))]


def shard_ranges(n_rows: int, d: int) -> list[tuple[int, int]]:
    """The [lo, hi) row range of each of d equal shards of n_rows rows (a
    multiple of d)."""
    r = n_rows // d
    return [(j * r, (j + 1) * r) for j in range(d)]

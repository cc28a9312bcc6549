"""Step-communication strategy of the port: one engine loop over the
devices of one process.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/comm.py
LocalStepComm (comm.py:40-82), with the method names the count and collect
paths use; parallel/distributed.py DistStepComm is the multi-process
strategy with the same contract:

  is_local            True: a single participant (an empty file list is an error)
  devices()           the shards' torch.devices, in order (make_mesh)
  device()            the first of them
  inflight()          device steps in flight before the host waits (a step
                      is every shard's launches)
  put(arrays)         a step's numpy operands, rows a multiple of the shard
                      count -> one tuple of tensors a shard, on its device
  put_one(arrays)     numpy operands -> tensors on the first device
  fetch(t)            a shard's output -> numpy on the host
  finish_total(d, h)  final count from device-step total + host-side total
  reduce_sum(v)       sum a host-local value across participants

The JAX contract's lockstep hooks (agree_block_size, batch_rows, step_rows,
agree_steps, agree_widths, agree_cap) are gone: every host of a JAX run
dispatches the same SPMD program, but here each process launches its own
steps, and the collect path has no cap.

Each shard's K blocks ride one launch on its device (parallel/mesh.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def require_device(device) -> torch.device:
    """The torch.device asked for, checked to exist: a CUDA device without
    CUDA raises instead of running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    return device


def indexed(device: torch.device) -> torch.device:
    """A CUDA device with no index -> the current card's, which is the
    device of the tensors made on it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class LocalStepComm:
    """Single-process strategy over devices: a torch.device, its name, or a
    list of them, one a shard (parallel/mesh.py local_devices)."""

    # a lone participant: an empty file list is an error (run_query)
    is_local = True

    def __init__(self, devices):
        if isinstance(devices, (list, tuple)):
            if not devices:
                raise ValueError("a query needs at least one device")
            self._devices = [indexed(require_device(d)) for d in devices]
        else:
            self._devices = [indexed(require_device(devices))]

    def devices(self) -> list[torch.device]:
        return list(self._devices)

    def device(self) -> torch.device:
        return self._devices[0]

    def inflight(self) -> int:
        return int(os.environ.get("AQPC_INFLIGHT") or 3)

    def put(self, arrays: tuple) -> list[tuple]:
        from .mesh import split_rows

        return [tuple(torch.from_numpy(a).to(dev) for a in group)
                for dev, group in zip(self._devices, split_rows(arrays, len(self._devices)))]

    def put_one(self, arrays: tuple) -> tuple:
        """numpy operands -> tensors on the first device alone (a step of
        one row: the density path's host-gathered hits)."""
        return tuple(torch.from_numpy(a).to(self._devices[0]) for a in arrays)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def finish_total(self, device_total: int, host_total: int) -> int:
        return self.reduce_sum(device_total + host_total)

    def reduce_sum(self, value: int) -> int:
        return value

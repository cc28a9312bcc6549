"""Step-communication strategy of the port: one engine loop, one device.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/comm.py
LocalStepComm (comm.py:40-82), with the method names the count and collect
paths use; parallel/distributed.py DistStepComm is the multi-process
strategy with the same contract:

  is_local            True: a single participant (an empty file list is an error)
  device()            the torch.device every step runs on (make_mesh there)
  inflight()          device steps in flight before the host waits
  put(arrays)         numpy step operands -> tensors on the device
  fetch(t)            a step output -> numpy on the host
  finish_total(d, h)  final count from device-step total + host-side total
  reduce_sum(v)       sum a host-local value across participants

The JAX contract's lockstep hooks (agree_block_size, batch_rows, step_rows,
agree_steps, agree_widths, agree_cap) are gone: every host of a JAX run
dispatches the same SPMD program, but here each process launches its own
steps, and the collect path has no cap.

With one device there is no mesh: the K blocks of a step ride one launch.
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


class LocalStepComm:
    """Single-process strategy: everything is identity on one device."""

    # a lone participant: an empty file list is an error (run_query)
    is_local = True

    def __init__(self, device):
        self._device = require_device(device)

    def device(self) -> torch.device:
        return self._device

    def inflight(self) -> int:
        return int(os.environ.get("AQPC_INFLIGHT") or 3)

    def put(self, arrays: tuple) -> tuple:
        return tuple(torch.from_numpy(a).to(self._device) for a in arrays)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def finish_total(self, device_total: int, host_total: int) -> int:
        return self.reduce_sum(device_total + host_total)

    def reduce_sum(self, value: int) -> int:
        return value

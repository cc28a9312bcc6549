"""Step-communication strategy of the port: one engine loop, one device.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/comm.py
LocalStepComm (comm.py:40-82), with the method names the count and collect
paths use, so that a multi-process strategy can slot in later with the same
contract:

  is_local            True: a single participant, free to skip steps
  device()            the torch.device every step runs on (make_mesh there)
  agree_block_size(b) block shape all participants use
  batch_rows(k)       rows this process feeds per step
  step_rows(n, r)     rows this process's step operands are padded to
  agree_steps(n)      total steps all participants dispatch (0 = none needed)
  agree_widths(w)     per-step packed-transport width vector
  inflight()          device steps in flight before the host waits
  put(arrays)         numpy step operands -> tensors on the device
  fetch(t)            a step output -> numpy on the host
  finish_total(d, h)  final count from device-step total + host-side total
  reduce_sum(v)       sum a host-local value across participants

The collect path has no cap, so the JAX contract's agree_cap is gone.

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

    # the host resolves some blocks with no device step (the class
    # dictionary's absent-target and single-class blocks); that changes the
    # step count, which only a lone participant may do
    is_local = True

    def __init__(self, device):
        self._device = require_device(device)

    def device(self) -> torch.device:
        return self._device

    def agree_block_size(self, block_size: int) -> int:
        return block_size

    def batch_rows(self, blocks_per_device: int) -> int:
        return blocks_per_device

    def step_rows(self, n_batch: int, rows_per_step: int) -> int:
        return n_batch  # short tail flushes pay for no padding rows

    def agree_steps(self, n_steps: int) -> int:
        return 0  # no lockstep needed: flush exactly what the feeder yields

    def agree_widths(self, widths: np.ndarray) -> np.ndarray:
        return widths

    def inflight(self) -> int:
        return int(os.environ.get("AQPC_INFLIGHT") or 3)

    def put(self, arrays: tuple) -> tuple:
        return tuple(torch.from_numpy(a).to(self._device) for a in arrays)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def finish_total(self, device_total: int, host_total: int) -> int:
        return device_total + host_total

    def reduce_sum(self, value: int) -> int:
        return value

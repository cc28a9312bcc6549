"""The plain reference: what every `serve` count request should answer,
from the columns the benchmark wrote, in plain PyTorch.

It imports numpy and torch only: nothing of the program, nothing of JAX.
It takes the columns the benchmark generated and wrote for the program
(synth.Dataset: raw positions, classes, GPS times, each file's scale and
offset) and works everything else out itself, with the semantics the
program documents
(adhoc_queries_pointclouds_torch/serve.py, models/query.py):

  box      points whose world position offset + scale x raw lies in the
           closed box, componentwise
  class    points of that class
  time     points whose GPS time t has t0 <= t < t1

dtype is the precision of the arithmetic: torch.float64 is the reference;
torch.float32 is its control, the same semantics one precision below
(PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    """The dataset's columns on device, in dtype, and the answers."""

    def __init__(self, dataset, device, dtype=torch.float64):
        self.dtype = dtype
        self.device = torch.device(device)
        world, cls, gps = [], [], []
        scale = np.asarray(dataset.scale, np.float64)
        for cols, offset in zip(dataset.columns, dataset.offsets):
            offset = np.asarray(offset, np.float64)
            raw = torch.from_numpy(cols["raw"]).to(self.device)
            w = (raw.to(dtype) * torch.tensor(scale, dtype=dtype, device=self.device)
                 + torch.tensor(offset, dtype=dtype, device=self.device))
            world.append(w)
            cls.append(torch.from_numpy(cols["cls"]).to(self.device))
            if "gps" in cols:
                gps.append(torch.from_numpy(cols["gps"]).to(self.device).to(dtype))
        self.world = torch.cat(world)
        self.cls = torch.cat(cls)
        self.gps = torch.cat(gps) if gps else None

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _in_box(self, bounds) -> torch.Tensor:
        m = torch.ones(self.world.shape[0], dtype=torch.bool, device=self.device)
        for a in range(3):
            col = self.world[:, a]
            m &= (col >= self._scalar(bounds[a])) & (col <= self._scalar(bounds[a + 3]))
        return m

    def answer(self, req: dict) -> int:
        """The count a `serve` count request should reply with."""
        if "bounds" in req:
            return int(self._in_box([float(v) for v in req["bounds"]]).sum())
        if "class" in req:
            return int((self.cls == int(req["class"])).sum())
        if "time_range" in req:
            if self.gps is None:
                raise ValueError("the dataset has no GPS times")
            t0, t1 = (self._scalar(float(v)) for v in req["time_range"])
            return int(((self.gps >= t0) & (self.gps < t1)).sum())
        raise ValueError(f"no reference for request {req}")

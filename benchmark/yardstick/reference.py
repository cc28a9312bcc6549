"""The plain reference: what every `serve` request should answer, from the
columns the benchmark wrote, in plain PyTorch.

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

A collect request ("collect": true, "limit": K) is answered with the count,
the preview and whether it is truncated: the first K hits in the order
serve emits them (files in the dataset's order, ascending point index
within each file), each [x, y, z, class] with the world coordinates
offset + scale x raw rounded to 6 decimals as serve rounds them (Python's
round of a numpy float64). An -o request's files are judged by each file's
hits (file_hits), in that order.

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
        self.starts = np.cumsum([0, *dataset.counts])  # each file's first row, then the end

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _in_box(self, bounds) -> torch.Tensor:
        m = torch.ones(self.world.shape[0], dtype=torch.bool, device=self.device)
        for a in range(3):
            col = self.world[:, a]
            m &= (col >= self._scalar(bounds[a])) & (col <= self._scalar(bounds[a + 3]))
        return m

    def _mask(self, req: dict) -> torch.Tensor:
        """The request's hits over every point, files in order."""
        if "bounds" in req:
            return self._in_box([float(v) for v in req["bounds"]])
        if "class" in req:
            return self.cls == int(req["class"])
        if "time_range" in req:
            if self.gps is None:
                raise ValueError("the dataset has no GPS times")
            t0, t1 = (self._scalar(float(v)) for v in req["time_range"])
            return (self.gps >= t0) & (self.gps < t1)
        raise ValueError(f"no reference for request {req}")

    def answer(self, req: dict) -> int:
        """The count a `serve` request should reply with."""
        return int(self._mask(req).sum())

    def reply(self, req: dict) -> dict:
        """What a `serve` reply should hold but its time and file names: the
        count and, for a collect request, the preview and whether it is
        truncated."""
        mask = self._mask(req)
        out = {"count": int(mask.sum())}
        if req.get("collect"):
            at = torch.nonzero(mask).flatten()[:int(req.get("limit", 1000))]
            world = self.world[at].to(torch.float64).cpu().numpy()
            out["points"] = [preview_point(p, c) for p, c in zip(world, self.cls[at].tolist())]
            out["truncated"] = out["count"] > len(out["points"])
        return out

    def file_hits(self, req: dict) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each file's hits, for every file that has any, in the dataset's
        order: (n, 3) float64 world coordinates and (n,) uint8 classes,
        ascending point index."""
        mask = self._mask(req)
        out = []
        for lo, hi in zip(self.starts[:-1].tolist(), self.starts[1:].tolist()):
            at = torch.nonzero(mask[lo:hi]).flatten() + lo
            if len(at):
                out.append((self.world[at].to(torch.float64).cpu().numpy(),
                            self.cls[at].cpu().numpy()))
        return out


def preview_point(p: np.ndarray, cls: int) -> list:
    """One preview point as serve writes it: x, y and z, numpy float64s,
    each rounded to 6 decimals by Python's round, and the class."""
    return [float(round(p[0], 6)), float(round(p[1], 6)), float(round(p[2], 6)), int(cls)]

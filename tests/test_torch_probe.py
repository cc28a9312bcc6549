"""The port's bbox probe (kernel g) against the JAX probe's Pallas bodies.

tools/bboxprobe.py of the JAX package is a script, not a package module, so
it is loaded with importlib. Its two bodies, _bbox_kernel_acc and
_bbox_kernel_acc_nomask, run on the CPU in Pallas interpret mode through a
pallas_call built as the script's _call_bbox builds it; the port's plain
versions (what its wrappers run on CPU tensors) must give the same counts.
The probe tool of the port then runs end to end on the CPU. Counts are
integers: the tolerance is 0.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adhoc_queries_pointclouds_torch.ops import predicate as TP
from adhoc_queries_pointclouds_torch.tools import bboxprobe as torch_probe

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location("jax_bboxprobe", ROOT / "tools" / "bboxprobe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_count(mod, kernel, x, y, z, lo, hi, n_valid) -> int:
    """bbox_probe's pallas_call (bboxprobe.py:110-139) in interpret mode."""
    n = x.shape[0]
    rows = n // mod.LANES
    coord_spec = pl.BlockSpec((mod.TILE_ROWS, mod.LANES), lambda i, *_: (i, 0),
                              memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(rows // mod.TILE_ROWS,),
            in_specs=[coord_spec, coord_spec, coord_spec],
            out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
            scratch_shapes=[pltpu.VMEM((mod.TILE_ROWS, mod.LANES), jnp.int32)],
        ),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True,
    )
    bounds = jnp.concatenate([jnp.asarray(lo), jnp.asarray(hi)])
    nvalid = jnp.asarray(n_valid, jnp.int32).reshape(1)
    x2, y2, z2 = (jnp.asarray(a).reshape(rows, mod.LANES) for a in (x, y, z))
    return int(call(bounds, nvalid, x2, y2, z2)[0, 0])


@pytest.mark.parametrize("nv_case", ["full", "ragged", "zero"])
def test_probe_plain_versions_match_pallas_bodies(jax_probe, nv_case):
    n = 2 * jax_probe.TILE_ROWS * jax_probe.LANES
    rng = np.random.default_rng({"full": 1, "ragged": 2, "zero": 3}[nv_case])
    x, y, z = (rng.integers(-(2**30), 2**30, n).astype(np.int32) for _ in range(3))
    lo = np.array([-(2**29), -(2**28), np.iinfo(np.int32).min], np.int32)
    hi = np.array([2**29, 2**30, np.iinfo(np.int32).max], np.int32)
    nv = {"full": n, "ragged": n - 123_457, "zero": 0}[nv_case]
    acc = _pallas_count(jax_probe, jax_probe._bbox_kernel_acc, x, y, z, lo, hi, nv)
    nomask = _pallas_count(jax_probe, jax_probe._bbox_kernel_acc_nomask, x, y, z, lo, hi, nv)
    tx, ty, tz, tlo, thi = (torch.from_numpy(a) for a in (x, y, z, lo, hi))
    tnv = torch.tensor(nv, dtype=torch.int32)
    got = TP.bbox_probe_acc_kernel(tx, ty, tz, tlo, thi, tnv)
    assert got.dim() == 0 and got.dtype == torch.int32 and int(got) == acc
    assert int(TP.bbox_probe_acc(tx, ty, tz, tlo, thi, tnv)) == acc
    assert int(TP.bbox_probe_acc_nomask_kernel(tx, ty, tz, tlo, thi)) == nomask
    oracle = np.all((np.stack([x, y, z], 1) >= lo) & (np.stack([x, y, z], 1) <= hi), axis=1)
    assert acc == int(oracle[:nv].sum()) and nomask == int(oracle.sum())
    assert TP.launches["bbox_probe_acc"] == TP.launches["bbox_probe_acc_nomask"] == 0


@pytest.mark.parametrize("n", [262144, 100_003])
def test_probe_tool_runs_on_cpu(capsys, n):
    """Every row of the port's probe on CPU tensors: bbox rows agree, class
    rows agree, and no time is reported for a host run."""
    assert torch_probe.main(["--n", str(n), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if " count " in line]
    assert len(rows) == 7
    assert all("time not measured" in line for line in rows)
    results = torch_probe.run(n, 1, "cpu")
    bbox = {r["count"] for r in results.values() if r["group"] == "bbox"}
    cls = {r["count"] for r in results.values() if r["group"] == "class"}
    assert len(bbox) == len(cls) == 1 and bbox.pop() > 0 and cls.pop() > 0


def test_probe_tool_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_probe.main(["--n", "1024"])

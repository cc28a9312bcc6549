"""The port's GPS-time count end to end against the JAX engine, on the CPU.

The same point-format-3 dataset and half-open time range go through
adhoc_queries_pointclouds_tpu's run_query and the port's
run_query(device="cpu"); match counts must be equal over every format, in
both transports (AQPC_PACK 0/1), with the sidecar index off and with an
exact index (GPS min/max per index block, built as the JAX CLI's index
command builds it). Counts are integers: the tolerance is 0.
"""

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from test_torch_engine import run
from test_torch_engine_class import BLOCK, FORMATS, exact_index_copy, write_data

# files are 200k points at 200k points/s of one flight line: file 0 holds
# times in [0, 1), file 1 in [1, 2)
RANGES = {
    "partial": (0.3, 0.7),
    "everything": (-1.0, 10.0),
    "nothing": (5.0, 6.0),
    "straddling": (0.8, 1.3),
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine_time")
    write_data(root / "data", seed=9)
    for fmt in FORMATS:
        exact_index_copy(root / "data" / fmt, root / f"idx_{fmt}")
    return root


def _oracle(data_dir, t0: float, t1: float) -> int:
    total = 0
    for f in sorted(data_dir.iterdir()):
        if f.suffix == ".aqpc-idx":
            continue
        r = open_point_cloud(f)
        g = r.column("gps_time")
        total += int(np.count_nonzero((g >= t0) & (g < t1)))
        r.close()
    return total


@pytest.mark.parametrize("name", sorted(RANGES))
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("use_index", [False, True], ids=["noindex", "index"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_time_count_matches_jax_engine(dataset, monkeypatch, fmt, use_index, pack, name):
    monkeypatch.setenv("AQPC_PACK", pack)
    t0, t1 = RANGES[name]
    spec = dict(time=(t0, t1))
    data = dataset / (f"idx_{fmt}" if use_index else f"data/{fmt}")
    ref = run(jax_engine, data, spec, block_size=BLOCK, use_index=use_index)
    got = run(torch_engine, data, spec, block_size=BLOCK, use_index=use_index)
    assert got.match_count == ref.match_count == _oracle(dataset / "data" / fmt, t0, t1)
    assert got.points_scanned == ref.points_scanned
    assert (got.match_count == 0) == (name == "nothing")
    if name == "everything":
        assert got.match_count == 400_000
    if use_index and name != "everything":
        assert got.timer.counts["index_pruned_points"] > 0


@pytest.mark.parametrize("pack", ["1", "0"])
def test_time_count_block_size_not_multiple_of_4(dataset, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    t0, t1 = RANGES["straddling"]
    spec = dict(time=(t0, t1))
    for data, use_index in ((dataset / "data" / "lazer", False), (dataset / "idx_lazer", True)):
        ref = run(jax_engine, data, spec, block_size=40_003, use_index=use_index)
        got = run(torch_engine, data, spec, block_size=40_003, use_index=use_index)
        assert got.match_count == ref.match_count == _oracle(dataset / "data" / "lazer", t0, t1)


@pytest.mark.parametrize("fmt", FORMATS)
def test_time_range_over_gps_less_files_raises(tmp_path, fmt):
    synth.write_dataset(tmp_path, n_files=1, points_per_file=1000, seed=2, formats=(fmt,))
    spec = dict(time=(0.0, 1.0))
    with pytest.raises(ValueError, match="does not contain GPS times!") as want:
        run(jax_engine, tmp_path / fmt, spec)
    with pytest.raises(ValueError, match="does not contain GPS times!") as got:
        run(torch_engine, tmp_path / fmt, spec)
    assert str(got.value) == str(want.value)

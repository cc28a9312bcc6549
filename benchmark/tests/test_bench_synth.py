"""The frozen generator: the same seed gives the same tile, pinned to a
committed digest (not to the program's formats/synth.py), and the files
it writes read back as the program reads them."""

import hashlib

import numpy as np
import pytest
import torch

from yardstick import synth

# sha256 of a 4,096-point point-format-1 tile's raw, class and GPS bytes,
# seed tile_seed(7, "doc", 0), on the CPU
DIGEST = "8209f379e2facbc78b71765413c004c75ff199146ee2987852e50163564a110f"


def tile_digest(tile) -> str:
    h = hashlib.sha256()
    for t in (tile.raw, tile.cls, tile.gps):
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def small_tile(seed=7, n=4096, **kw):
    return synth.make_tile(n, seed=synth.tile_seed(seed, "doc", 0), device="cpu",
                           point_format=1, **kw)


def test_same_seed_same_tile():
    a, b = small_tile(), small_tile()
    assert tile_digest(a) == tile_digest(b)
    assert tile_digest(small_tile(seed=8)) != tile_digest(a)


def test_digest_is_pinned():
    assert tile_digest(small_tile()) == DIGEST


def test_tile_seeds_differ_by_seed_config_and_tile():
    seeds = {synth.tile_seed(s, c, i) for s in (0, 2**31 + 7, 2**40) for c in ("doc", "navvis")
             for i in range(3)}
    assert len(seeds) == 18
    assert synth.tile_seed(-1, "doc", 0) == synth.tile_seed(2**64 - 1, "doc", 0)


def test_tile_shape():
    t = small_tile(n=20_000)
    assert t.raw.dtype == torch.int32 and t.raw.shape == (20_000, 3)
    assert int(t.raw.min()) >= 0 and int(t.raw[:, 0].max()) <= 1_000_000
    assert set(t.cls.unique().tolist()) <= {2, 3, 5, 6}
    gps = t.gps.numpy()
    assert np.all(np.diff(gps) > 0)
    # no time lies on an edge the traffic uses: (k + 0.75) / rate
    frac = (gps * 200_000.0) % 1.0
    assert frac.max() < 0.5 + 1e-6
    world = t.raw.numpy() * 0.001 + np.asarray(t.offset)
    assert np.allclose(world.min(axis=0), t.wmin) and np.allclose(world.max(axis=0), t.wmax)


@pytest.mark.parametrize("fmt", [0, 1])
def test_files_read_back_as_the_program_reads_them(tmp_path, fmt):
    from adhoc_queries_pointclouds_torch.formats import open_point_cloud

    config = {"name": "t", "points": 30_001, "tiles": 3, "point_format": fmt,
              "scale": [0.001] * 3, "offset": [100000.0, 200000.0, 0.0],
              "tile_extent_m": [1000.0, 1000.0, 100.0], "classes": [2, 3, 5, 6],
              "generator": {"n_clusters": 8, "cluster_frac": 0.7, "sigma_frac": 0.015}}
    ds = synth.make_dataset(config, 5, tmp_path, "cpu")
    assert ds.counts == [10_000, 10_000, 10_001] and ds.total_points == 30_001
    assert [f.stat().st_size for f in ds.files] == [227 + synth.RECORD_LENGTH[fmt] * n
                                                    for n in ds.counts]
    start = 0
    for i, path in enumerate(ds.files):
        mine = synth.read_columns(path, fmt)
        r = open_point_cloud(path)
        assert r.header.point_count == ds.counts[i]
        assert tuple(r.header.min) == ds.wmin[i] and tuple(r.header.max) == ds.wmax[i]
        assert tuple(r.header.offset) == ds.offsets[i]
        np.testing.assert_array_equal(r.column("position"), mine["raw"])
        np.testing.assert_array_equal(r.column("classification"), mine["cls"])
        assert not r.column("intensity").any()
        if fmt == 1:
            np.testing.assert_array_equal(r.column("gps_time"), mine["gps"])
            assert mine["gps"][0] == pytest.approx(start / 200_000.0, abs=3e-6)
        assert "gps" not in mine or fmt == 1
        start += ds.counts[i]
        r.close()

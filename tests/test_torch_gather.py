"""The resident density path's candidate gather, the port against the JAX
package, on the CPU.

The JAX package selects a file's density candidates and gathers their x, y
and z in one jitted call, density_candidates_gather
(adhoc_queries_pointclouds_tpu/ops/density.py:597): per block a count, the
candidates' row indices (K, cap) and x, y, z taken at them. The port gets
the same from two calls, as parallel/resident.py makes them: the
candidates as a bit mask (ops/density.py density_candidates_bits, its
plain version on CPU tensors), then the compaction that gathers
(ops/compact.py compact_bits_gather_plain, the plain version of
csrc/compact_bits.cu compact_bits_gather) into one buffer at each block's
offset.

The same seeded numpy blocks go through both: predicate hit shares 0,
0.001, 1/2 and 1 and one block with n_valid < B, at block sizes that are
no multiple of 8,192 (one also none of 32: a partial last mask word), over
grids whose cells hold under one point (every hit a candidate), a few
(most hits) and about ten (about one a cell). Held at tolerance 0 (int32):
every block's count, and its first count indices and x, y, z, in the same
order. The coordinates stay far from the int32 ends, so neither rule of
the candidate selection that the two packages keep apart on purpose (F4 in
ROADMAP.md) is reached.

Then, on the CPU, what the card's tests of the kernel stand on: the edges
that tests/test_torch_cuda.py and chip_smoke.py hold the kernel to are the
edges they are named for, at the kernel's own dense threshold; the sector
count of its bound; the build's ptxas report.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu.ops import density as jd
from adhoc_queries_pointclouds_tpu.utils.aabb import AABB as JaxAABB
from adhoc_queries_pointclouds_torch import _build
from adhoc_queries_pointclouds_torch.ops import compact as tc
from adhoc_queries_pointclouds_torch.ops import density as td
from adhoc_queries_pointclouds_torch.ops import predicate as tp
from adhoc_queries_pointclouds_torch.tools import packed_bench
from adhoc_queries_pointclouds_torch.utils.aabb import AABB

SHARES = (0.0, 0.001, 0.5, 1.0, 1.0)  # the last block: n_valid < B
SCALE, OFFSET = (0.01, 0.01, 0.01), (0.0, 0.0, 0.0)
SPAN = 200_000  # coordinate range of the raw int32 values: 2 km at SCALE
GATHER = jax.jit(jd.density_candidates_gather, static_argnames="cap")


def blocks(block_size: int, seed: int):
    """(x, y, z) (K, B) int32, the predicate's (K, B) bool rows with the
    rows at or past n_valid cleared (as every mask kernel leaves them), and
    n_valid (K,) int32."""
    rng = np.random.default_rng(seed)
    k_blocks = len(SHARES)
    xyz = [rng.integers(0, SPAN, (k_blocks, block_size)).astype(np.int32) for _ in range(3)]
    nvs = np.full(k_blocks, block_size, np.int32)
    nvs[-1] = block_size - 1000 - 3
    rows = rng.random((k_blocks, block_size)) < np.array(SHARES)[:, None]
    rows &= np.arange(block_size) < nvs[:, None]
    return xyz, rows, nvs


@pytest.mark.parametrize("block_size", [8192 + 1000 + 13, 2 * 8192 + 96], ids=["B%32", "B%8192"])
@pytest.mark.parametrize("cell", [0.05, 40.0, 200.0],
                         ids=["under_one_a_cell", "some_a_cell", "many_a_cell"])
def test_candidate_gather_matches_jax(block_size, cell):
    xyz, rows, nvs = blocks(block_size, seed=block_size + int(cell * 100))
    bounds = (np.array([0.0, 0.0, 0.0]), np.array([SPAN * 0.01] * 3))
    tables = td.GridSpec3D.create(AABB(*map(tuple, bounds)), cell).file_tables(SCALE, OFFSET)
    ref_tables = jd.GridSpec3D.create(JaxAABB(*map(tuple, bounds)), cell).file_tables(SCALE,
                                                                                     OFFSET)
    counts, idx, gx, gy, gz = (np.asarray(a) for a in GATHER(
        *(jnp.asarray(c) for c in xyz), jnp.asarray(rows), jnp.asarray(nvs),
        {k: jnp.asarray(v) for k, v in ref_tables.items()}, cap=block_size))

    cols = tuple(torch.from_numpy(c) for c in xyz)
    cands = td.density_candidates_bits(cols, tp.pack_mask_bits(torch.from_numpy(rows)),
                                       torch.from_numpy(nvs), td.tables_to_device(tables, "cpu"),
                                       block_size)
    got_counts = cands.counts.numpy()
    offsets = np.concatenate([[0], np.cumsum(got_counts)[:-1]]).astype(np.int64)
    total = int(got_counts.sum())
    out = [t.numpy() for t in tc.compact_bits_gather_plain(
        cands.bits, cands.chunks, torch.from_numpy(offsets), total, block_size, *cols)]

    assert got_counts.dtype == np.int32 and all(t.dtype == np.int32 for t in out)
    assert np.array_equal(got_counts, np.asarray(counts, np.int32))
    assert got_counts[0] == 0 and got_counts[1:].min() > 0  # every share but 0 has candidates
    for k, (o, c) in enumerate(zip(offsets, got_counts)):
        for mine, ref in zip(out, (idx, gx, gy, gz)):
            assert np.array_equal(mine[o:o + c], ref[k, :c]), k


# ------------------------------------------- the card's edges, on the CPU

def test_dense_threshold_matches_the_kernel():
    """tools/packed_bench.py GATHER_DENSE_HITS, which the edges are built
    at, is csrc/compact_bits.cu kDenseHits."""
    src = (Path(tc.__file__).parents[1] / "csrc" / "compact_bits.cu").read_text()
    kernel = int(re.search(r"constexpr int kDenseHits = (\d+);", src).group(1))
    assert packed_bench.GATHER_DENSE_HITS == kernel


def test_gather_edges_are_the_named_edges():
    """The card test's and the smoke's edges hold what their labels say:
    tiles at the dense threshold and one below it, the warp spans of block
    1's first tile, the partial last word at B % 4 == 0 and 1."""
    cases = {label: (rows, skip) for label, rows, skip in packed_bench.gather_edges()}
    rows, _ = cases["edges"]
    tiles = rows.reshape(rows.shape[0], -1, 8192).sum(-1)
    dense = packed_bench.GATHER_DENSE_HITS
    assert tiles[6].tolist() == [dense, dense - 1] and tiles[7].tolist() == [dense, dense - 1]
    assert rows[6, :8192].reshape(-1, 8).sum(-1).tolist() == [1] * 1024  # one hit a sector
    assert rows[1, :8192].reshape(8, 1024).sum(-1).tolist() == [128, 127, 128, 1024, 0, 1024, 64,
                                                                120]
    assert tiles[2].tolist() == [0, 8192] and tiles[1, 1] == 8192
    # 3, 1 and 2 hits: the later blocks' outputs start off 16-byte boundaries
    assert [np.nonzero(rows[k])[0].tolist() for k in (0, 3, 5)] == [[0, 1, 2], [5], [0, 1]]
    for label in ("partial last word, B % 4 == 0", "partial last word, B % 4 == 1"):
        rows, _ = cases[label]
        assert rows.shape[1] % 32 == 8 + int(label[-1]) and rows[2, -3:].all()
        assert rows[1].all() and rows.shape[1] % 8192 >= dense  # a dense last tile


@pytest.mark.parametrize("skip", [(), (1,), (0, 1, 2)])
def test_gather_sector_bytes_counts_touched_sectors(skip):
    rng = np.random.default_rng(len(skip))
    rows = rng.random((3, 8 * 1000 + 5)) < np.array([[0.001], [0.05], [0.9]])
    kept = rows.copy()
    kept[list(skip)] = False
    k, r = np.nonzero(kept)
    want = 3 * 32 * len(np.unique((k * rows.shape[1] + r) // 8))  # a sector may span two blocks
    assert packed_bench.gather_sector_bytes(torch.from_numpy(rows), skip) == want


def test_build_keeps_the_ptxas_report():
    """The kernel library is built with ptxas's report (-Xptxas -v), kept
    beside it as nvcc.log, which the smoke's phase 1 reads."""
    i = _build.NVCC_FLAGS.index("-Xptxas")
    assert _build.NVCC_FLAGS[i + 1] == "-v"
    assert _build.build_log_path() == _build.library_path().with_name("nvcc.log")

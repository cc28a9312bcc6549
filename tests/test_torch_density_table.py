"""The leaders table of the port's density kernels, on the CPU: its size
(table_slots), its slot layout (slot_bytes), the decoder table_leaders on
tables built by hand in both layouts, and the wrappers' refusal of a table
whose size fits no layout. The kernels that fill and read the table run on
the card only (tests/test_torch_cuda.py); everything here is exact.
"""

import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_torch.ops import density as td
from adhoc_queries_pointclouds_torch.utils.aabb import AABB


@pytest.mark.parametrize("hits,cells,want", [
    (0, None, 64),
    (5000, None, 16384),
    (1 << 21, None, 1 << 22),  # the one-argument value is unchanged
    (1 << 21, 154_350, 1 << 19),  # fewer cells than hits: sized by the cells
    (1 << 21, 6125, 16384),
    (1000, 10**9, 2048),  # more cells than hits: sized by the hits
    (1 << 21, 1 << 21, 1 << 22),
    (1 << 21, 1, 64),  # one cell
    (3, 2**64, 64),
], ids=str)
def test_table_slots(hits, cells, want):
    assert td.table_slots(hits, cells) == want
    if cells is None:
        assert td.table_slots(hits) == want


@pytest.mark.parametrize("cells,want", [
    (1, 8), (2**32 - 1, 8), (2**32, 16), (2**40, 16), (2**64, 16),
], ids=str)
def test_slot_layout_by_cells(cells, want):
    assert td.slot_bytes(cells) == want


def test_grid_cells_picks_the_layout():
    """grid_cells reads the cell count from the tables' shapes; a grid of
    20000 x 20000 x 2000 cells (>= 2^32) takes the 16-byte slots, and a
    degenerate axis counts one cell."""
    scale, offset = (0.001,) * 3, (0.0,) * 3
    for bmax, cell, cells in (((1000.0, 1000.0, 100.0), 0.05, 20000 * 20000 * 2000),
                              ((1000.0, 1000.0, 100.0), 10.0, 100 * 100 * 10),
                              ((1000.0, 1000.0, 0.0), 10.0, 100 * 100)):
        grid = td.GridSpec3D.create(AABB((0.0, 0.0, 0.0), bmax), cell)
        t = td.tables_to_device(grid.file_tables(scale, offset), "cpu")
        assert td.grid_cells(t) == cells
        assert td.slot_bytes(td.grid_cells(t)) == (16 if cells >= 1 << 32 else 8)


def _word_table(k_blocks, slots, entries):
    """A table of 8-byte slots: entries {(block, slot): (key, d2 bits)}."""
    words = np.full((k_blocks, slots), 0xFFFFFFFFFFFFFFFF, np.uint64)
    for (k, s), (key, bits) in entries.items():
        words[k, s] = np.uint64(key) << np.uint64(32) | np.uint64(bits)
    return torch.from_numpy(words.view(np.int32).reshape(-1).copy())


def _wide_table(k_blocks, slots, entries):
    """A table of 16-byte slots (uint64 key, uint32 d2 bits, pad)."""
    slot = np.dtype([("key", "<u8"), ("d2", "<u4"), ("pad", "<u4")])
    rows = np.zeros((k_blocks, slots), slot)
    rows["key"], rows["d2"], rows["pad"] = 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF
    for (k, s), (key, bits) in entries.items():
        rows[k, s] = (key, bits, 0xFFFFFFFF)
    return torch.from_numpy(rows.view(np.int32).reshape(-1).copy())


def _as_i32(bits):
    return int(np.array(bits, np.uint32).view(np.int32))


@pytest.mark.parametrize("layout", ["word", "wide"])
def test_table_leaders_decodes_hand_built_tables(layout):
    """Occupied slots only, keys ascending as unsigned numbers, values as
    the int32 view of the d2 bits; empty blocks give empty tensors."""
    one = 0x3F800000  # 1.0f
    if layout == "word":
        cells = 2**32 - 1
        top = 2**32 - 2  # the largest key of such a grid
        entries = {(0, 5): (7, one), (0, 9): (3, 0), (0, 63): (top, 0x7F7FFFFF),
                   (2, 0): (0, 12345)}
        table = _word_table(3, 64, entries)
        assert table.numel() == 3 * 64 * 2
    else:
        cells = 2**64
        top = 2**64 - 2
        entries = {(0, 5): (7, one), (0, 9): (2**63 + 5, 0), (0, 63): (top, 0x7F7FFFFF),
                   (2, 0): (0, 12345)}
        table = _wide_table(3, 64, entries)
        assert table.numel() == 3 * 64 * 4
    got = td.table_leaders(table, 3, cells)
    assert len(got) == 3
    for k, (keys, vals) in enumerate(got):
        want = sorted((key, bits) for (b, _), (key, bits) in entries.items() if b == k)
        assert keys.dtype == torch.int64 and vals.dtype == torch.int32
        assert [int(v) & 0xFFFFFFFFFFFFFFFF for v in keys] == [key for key, _ in want]
        assert vals.tolist() == [_as_i32(bits) for _, bits in want]


def test_wrappers_refuse_a_table_that_fits_no_layout():
    grid = td.GridSpec3D.create(AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0)), 1.0)
    t = td.tables_to_device(grid.file_tables((0.001,) * 3, (0.0,) * 3), "cpu")
    step = ((torch.zeros((2, 8), dtype=torch.int32),) * 3, torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), t)
    for numel in (2 * 64 * 3, 2 * 48 * 2, 2 * 64 * 2 + 1, 0):  # the old 12-byte slots, ...
        bad = torch.zeros(numel, dtype=torch.int32)
        with pytest.raises(ValueError, match="fits no layout"):
            td.density_candidates(*step, bad, 8)
        with pytest.raises(ValueError, match="fits no layout"):
            td.table_leaders(bad, 2, td.grid_cells(t))
    good = torch.full((2 * 64 * 2,), -1, dtype=torch.int32)  # 64 word slots a block
    assert [len(k) for k, _ in td.table_leaders(good, 2, td.grid_cells(t))] == [0, 0]
    with pytest.raises(ValueError, match="take CUDA tensors"):  # the passes are kernels only
        td.density_candidates(*step, good, 8)

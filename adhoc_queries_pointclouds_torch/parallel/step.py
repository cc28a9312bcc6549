"""One device step: K stacked blocks -> one int32 total (count path), or a
bit mask and its hit indices (collect path); and a step over several
shards, one launch a shard (counts, collect_masks, density_masks).

The counterparts of adhoc_queries_pointclouds_tpu/parallel/mesh.py
sharded_bbox_count (mesh.py:416-423), sharded_bbox_count_packed
(mesh.py:113-121), sharded_class_count (mesh.py:426-451),
sharded_class_count_dict (mesh.py:193-216), sharded_time_count
(mesh.py:143-162) and sharded_time_count_packed (mesh.py:165-190). They take
the same (rows, B) operands of one shard (parallel/mesh.py): its K blocks
ride one kernel launch on its device and the per-block counts are summed
there. The result is a 0-d int32 tensor, read by the engine only when it
drains old steps; counts() gives one a shard, and the host sums them in
Python ints where JAX's psum summed them on the devices.

The collect step is the counterpart of mesh._collect_fn / sharded_collect
(mesh.py:229-302), split in two around the host's read of the counts:
collect_mask runs the kind's predicate into a BitMask (true per-block
counts included); once the engine has read the counts it gives each
partial block an offset, and collect_indices compacts exactly those
blocks' hits. There is no cap.

The density step is the counterpart of sharded_density and
sharded_density_packed (mesh.py:311-413): the kind's predicate through the
same bit-mask wrappers, then ops/density.py's candidate selection over the
step's x/y/z among the predicate's hits. Its result is a BitMask too, so
collect_indices finishes it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import compact, density, predicate

# collect kind (mesh.py:233-280) -> bit-mask wrapper; packed kinds take
# extra = (widths, block_size), class_dict (k, block_size)
_MASKS = {
    "bbox": predicate.bbox_mask_bits,
    "bbox_packed": predicate.bbox_mask_bits_packed,
    "class": predicate.class_mask_bits,
    "class_dict": predicate.class_mask_bits_dict,
    "time": predicate.time_mask_bits,
    "time_packed": predicate.time_mask_bits_packed,
}


def bbox_count(xs, ys, zs, los, his, nvs) -> torch.Tensor:
    """Raw-transport step: (rows, B) int32 x/y/z, (rows, 3) int32 bounds,
    (rows,) int32 n_valid."""
    counts = predicate.bbox_count_multi_kernel(xs, ys, zs, los, his, nvs)
    return counts.sum(dtype=torch.int32)


def bbox_count_packed(xp, yp, zp, los, his, nvs, widths, block_size: int) -> torch.Tensor:
    """Packed-transport step: (rows, row width) u8 plane stacks at widths
    (kx, ky, kz), residual-space (rows, 3) int32 bounds, (rows,) n_valid."""
    counts = predicate.bbox_count_packed_kernel(xp, yp, zp, los, his, nvs, widths, block_size)
    return counts.sum(dtype=torch.int32)


def class_count(cls, targets, nvs) -> torch.Tensor:
    """Raw class step: (rows, B // 4) int32 words (the u8 column viewed
    little-endian; the engine takes this form when B % 4 == 0) or (rows, B)
    u8 classes, (rows,) int32 targets and n_valid in points."""
    if cls.dtype == torch.int32:
        counts = predicate.class_count_words_kernel(cls, targets, nvs)
    else:
        counts = predicate.class_count_multi_kernel(cls, targets, nvs)
    return counts.sum(dtype=torch.int32)


def class_count_dict(cp, targets, nvs, k: int, block_size: int) -> torch.Tensor:
    """Dictionary class step: (rows, row width) u8 planes of k-bit codes,
    (rows,) int32 target codes (len(dict) on a miss) and n_valid."""
    counts = predicate.class_count_dict_kernel(cp, targets, nvs, k, block_size)
    return counts.sum(dtype=torch.int32)


def time_count(ths, tls, qs, nvs) -> torch.Tensor:
    """Raw GPS-time step: (rows, B) int32 encoded hi/lo words, (rows, 4)
    int32 encoded half-open ranges, (rows,) n_valid."""
    counts = predicate.time_count_multi_kernel(ths, tls, qs, nvs)
    return counts.sum(dtype=torch.int32)


def time_count_packed(thp, tlp, qs, nvs, widths, block_size: int) -> torch.Tensor:
    """Packed GPS-time step: (rows, row width) u8 plane stacks of the hi and
    lo words at widths (k_hi, k_lo), residual-space (rows, 4) ranges."""
    counts = predicate.time_count_packed_kernel(thp, tlp, qs, nvs, widths, block_size)
    return counts.sum(dtype=torch.int32)


# step kind (the engine's operand layout) -> count step; packed kinds take
# extra as in _MASKS
_COUNTS = {
    "bbox": bbox_count,
    "bbox_packed": bbox_count_packed,
    "class": class_count,
    "class_dict": class_count_dict,
    "time": time_count,
    "time_packed": time_count_packed,
}


def count(kind: str, arrays: tuple, extra: tuple = ()) -> torch.Tensor:
    """The 0-d int32 total of one count step over its (rows, ...) operands."""
    return _COUNTS[kind](*arrays, *extra)


def counts(kind: str, shards: list[tuple], extra: tuple = ()) -> list[torch.Tensor]:
    """count() of each shard's operands, on its device: one launch a shard.
    A step's packed widths (extra) are one set for every shard."""
    return [count(kind, arrays, extra) for arrays in shards]


def collect_mask(kind: str, arrays: tuple, extra: tuple = ()) -> predicate.BitMask:
    """The predicate of one collect step over its (rows, ...) operands, as
    sharded_collect takes them: kind and extra as in _MASKS."""
    return _MASKS[kind](*arrays, *extra)


def collect_masks(kind: str, shards: list[tuple], extra: tuple = ()) -> list[predicate.BitMask]:
    """collect_mask() of each shard's operands, on its device."""
    return [collect_mask(kind, arrays, extra) for arrays in shards]


def density_mask(kind: str, arrays: tuple, extra: tuple, xyz: tuple, tables: dict,
                 block_size: int, *, bases=None, widths=None,
                 slots: int | None = None) -> predicate.BitMask:
    """The candidates of one density step: the predicate of kind over its
    operands (arrays and extra as in collect_mask; the last array is the
    (rows,) n_valid), then the candidate selection over xyz: three (rows, B)
    int32 rows, or (widths given) three plane stacks with bases (rows, 3)
    int32. tables are the file's (density.tables_to_device); slots sizes the
    leaders table (density.table_slots of the step's largest hit count and
    the grid's cells)."""
    mask = _MASKS[kind](*arrays, *extra)
    return density.density_candidates_bits(xyz, mask, arrays[-1], tables, block_size,
                                           bases=bases, widths=widths, slots=slots)


def density_masks(kind: str, shards: list[tuple], extra: tuple, n_pred: int, xyz_at: int,
                  tables: dict, block_size: int, *, packed: bool, widths=None,
                  slots: int | None = None) -> list[predicate.BitMask]:
    """density_mask() of each shard's operands, on its device: a shard's
    arrays[:n_pred] are the predicate's, arrays[xyz_at:xyz_at + 3] the
    x/y/z, and (packed) its last array the bases. tables: the file's
    tables by device (density.tables_to_device on each)."""
    return [density_mask(kind, arrays[:n_pred], extra, arrays[xyz_at:xyz_at + 3],
                         tables[arrays[0].device], block_size,
                         bases=arrays[-1] if packed else None, widths=widths, slots=slots)
            for arrays in shards]


def density_mask_gathered(xyz: tuple, nvs, tables: dict, n: int, *,
                          slots: int | None = None) -> predicate.BitMask:
    """The candidates of host-gathered predicate hits: xyz are three (rows,
    n) int32 rows in which every row below n_valid is a hit (the density
    path's sparse blocks, engine.py:1759-1797)."""
    bits = torch.full((xyz[0].shape[0], predicate.mask_words(n)), -1, dtype=torch.int32,
                      device=xyz[0].device)
    return density.density_candidates_bits(xyz, predicate.BitMask(bits, None, None), nvs,
                                           tables, n, slots=slots)


def collect_indices(mask: predicate.BitMask, offsets, total: int,
                    block_size: int) -> torch.Tensor:
    """(total,) int32 ascending local hit rows of the blocks with an offset
    ((rows,) int64, -1 to skip a block), each at its offset."""
    return compact.compact_bits(mask.bits, mask.chunks, offsets, total, block_size)


def read_hits(masks: list, picked, block_size: int, fetch=None, timer=None):
    """The hits of one step's shards, one BitMask a shard (each a contiguous
    group of the step's rows, in order): the per-block counts of every
    shard, read first; then on each shard one compaction launch for the
    blocks picked(row, count) takes, each at its offset in that shard's
    exact-size buffer. fetch reads a tensor to numpy (the comm's), timer
    takes the reads as "d2h" stages. Returns the counts over the step's
    rows, each row's offset into the indices (-1: not picked) and the
    indices of the picked blocks in row order (None when there are none)."""
    fetch = fetch or (lambda t: t.cpu().numpy())

    def d2h(nbytes):
        return timer.stage("d2h", nbytes) if timer is not None else contextlib.nullcontext()

    counts = []
    for mask in masks:
        with d2h(mask.counts.nbytes):
            counts.append(fetch(mask.counts))
    counts = np.concatenate(counts)
    offsets = np.full(len(counts), -1, np.int64)
    parts = []
    base = 0
    r = len(counts) // len(masks)
    for s, mask in enumerate(masks):
        local = np.full(r, -1, np.int64)  # this shard's offsets into its own buffer
        total = 0
        for j in range(r):
            c = int(counts[s * r + j])
            if picked(s * r + j, c):
                local[j] = total
                offsets[s * r + j] = base + total
                total += c
        if not total:
            continue
        idx = collect_indices(mask, torch.from_numpy(local).to(mask.counts.device), total,
                              block_size)
        with d2h(4 * total):
            parts.append(fetch(idx))
        base += total
    return counts, offsets, (np.concatenate(parts) if parts else None)

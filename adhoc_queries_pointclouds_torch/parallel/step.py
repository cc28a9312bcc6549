"""One device step of the count path: K stacked blocks -> one int32 total.

The counterparts of adhoc_queries_pointclouds_tpu/parallel/mesh.py
sharded_bbox_count (mesh.py:416-423), sharded_bbox_count_packed
(mesh.py:113-121), sharded_class_count (mesh.py:426-451),
sharded_class_count_dict (mesh.py:193-216), sharded_time_count
(mesh.py:143-162) and sharded_time_count_packed (mesh.py:165-190). They take
the same (rows, B) operands; with one device there is no shard_map or psum,
so the K blocks ride one kernel launch and the per-block counts are summed
on the device. The result is a 0-d int32 tensor, read by the engine only
when it drains old steps.
"""

from __future__ import annotations

import torch

from ..ops import predicate


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

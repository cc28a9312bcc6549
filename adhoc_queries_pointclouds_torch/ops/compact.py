"""Hit-index compaction of the collect path: plain versions and the kernel.

The counterpart of adhoc_queries_pointclouds_tpu/ops/compact.py
masked_collect_multi (compact.py:86-99) and compact_indices (:34-43), with
one difference: there is no cap. The JAX package compacted each block into
a fixed-size buffer (a static shape for XLA) and retried the blocks whose
count exceeded it at a power-of-two bucket. Here the host reads each
block's true count first and asks for exactly that many indices, so there
is no cap, no bucket and no retry.

  masked_collect(mask)   (K, B) bool -> counts, ascending local hit indices
                         of every block in one exact-size int32 buffer, and
                         per-block offsets (plain, torch.nonzero)
  compact_indices(mask)  its one-block form
  compact_bits(...)      the collect path's compaction of a BitMask
                         (predicate.py) into an exact-size buffer, for the
                         blocks the caller gives an offset: the kernel in
                         csrc/compact_bits.cu on CUDA tensors, its plain
                         version on CPU tensors
  compact_bits_gather    compact_bits that also gathers three (K, B) int32
                         columns at the rows it writes (the resident
                         density path's x, y and z of the candidates);
                         the second kernel of csrc/compact_bits.cu

The kernels' launches are counted in predicate.launches["compact_bits"] and
["compact_bits_gather"].
"""

from __future__ import annotations

import torch

from . import predicate
from .predicate import _check, _on_cuda, mask_chunks, mask_words, unpack_mask_bits


def masked_collect(mask):
    """(K, B) bool -> (counts (K,) int32, indices (counts.sum(),) int32,
    offsets (K + 1,) int64): block j's hits, ascending, are
    indices[offsets[j]:offsets[j + 1]]."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    offsets = torch.zeros(mask.shape[0] + 1, dtype=torch.int64, device=mask.device)
    offsets[1:] = torch.cumsum(counts, 0)
    # row-major nonzero: block by block, each block's rows ascending
    indices = torch.nonzero(mask)[:, 1].to(torch.int32)
    return counts, indices, offsets


def compact_indices(mask):
    """(B,) bool -> (ascending indices (count,) int32, 0-d int32 count)."""
    counts, indices, _ = masked_collect(mask[None])
    return indices, counts[0]


def compact_bits_plain(bits, chunks, offsets, total: int, block_size: int):
    """The plain version of compact_bits (chunks are not needed: the plain
    version places each block's hits from its offset alone)."""
    del chunks
    rows = unpack_mask_bits(bits, block_size)
    out = torch.empty(total, dtype=torch.int32, device=bits.device)
    for j, off in enumerate(offsets.tolist()):
        if off >= 0:
            hits = torch.nonzero(rows[j])[:, 0].to(torch.int32)
            out[off : off + len(hits)] = hits
    return out


def compact_bits(bits, chunks, offsets, total: int, block_size: int):
    """BitMask words (K, ceil(B/32)) int32 and per-chunk counts (K,
    ceil(B/8192)) int32 of K blocks of B rows, (K,) int64 output offsets
    (-1: skip the block) -> (total,) int32: each block with an offset has
    its ascending hit rows at [offset, offset + its count). total must be
    the sum of the counts of the blocks with an offset. Replaces the
    jnp.nonzero compaction of masked_collect_multi (compact.py:86-99)."""
    if not _on_cuda(bits):
        return compact_bits_plain(bits, chunks, offsets, total, block_size)
    k_blocks = bits.shape[0]
    dev = bits.device
    _check(bits, "bits", torch.int32, (k_blocks, mask_words(block_size)), dev)
    _check(chunks, "chunks", torch.int32, (k_blocks, mask_chunks(block_size)), dev)
    _check(offsets, "offsets", torch.int64, (k_blocks,), dev)
    out = torch.empty(total, dtype=torch.int32, device=dev)
    predicate.run("compact_bits", (bits, chunks, offsets, out), (k_blocks, block_size))
    return out


def compact_bits_gather_plain(bits, chunks, offsets, total: int, block_size: int, xs, ys, zs):
    """The plain version of compact_bits_gather: compact_bits_plain, then
    each block's columns indexed at its rows."""
    idx = compact_bits_plain(bits, chunks, offsets, total, block_size)
    hits = unpack_mask_bits(bits, block_size).sum(dim=1).tolist()
    block = torch.empty(total, dtype=torch.int64, device=bits.device)
    for j, off in enumerate(offsets.tolist()):
        if off >= 0:
            block[off : off + hits[j]] = j
    rows = idx.to(torch.int64)
    return (idx, *(col[block, rows] for col in (xs, ys, zs)))


def compact_bits_gather(bits, chunks, offsets, total: int, block_size: int, xs, ys, zs):
    """compact_bits, with xs, ys, zs (K, B) int32 columns -> (idx, gx, gy,
    gz), each (total,) int32: idx as compact_bits gives it, and each
    column's value at the row idx names, in the row's block. No cap.
    Replaces density_candidates_gather's take_along_axis of x, y and z at
    the candidates' indices (adhoc_queries_pointclouds_tpu/ops/density.py:
    598-610)."""
    if not _on_cuda(bits):
        return compact_bits_gather_plain(bits, chunks, offsets, total, block_size, xs, ys, zs)
    k_blocks = bits.shape[0]
    dev = bits.device
    _check(bits, "bits", torch.int32, (k_blocks, mask_words(block_size)), dev)
    _check(chunks, "chunks", torch.int32, (k_blocks, mask_chunks(block_size)), dev)
    _check(offsets, "offsets", torch.int64, (k_blocks,), dev)
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        _check(t, name, torch.int32, (k_blocks, block_size), dev)
    outs = [torch.empty(total, dtype=torch.int32, device=dev) for _ in range(4)]
    predicate.run("compact_bits_gather", (bits, chunks, offsets, xs, ys, zs, *outs),
                  (k_blocks, block_size))
    return tuple(outs)

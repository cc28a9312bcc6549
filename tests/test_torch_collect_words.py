"""The placement rule of the ordered compaction and the word rule of the raw
class mask, on the CPU.

Both kernels are warp-cooperative (csrc/compact_bits.cu, csrc/mask_bits.cu
ClassRawTiles). This file holds a numpy, bit-level model of each against
the JAX package and the port's plain versions, exactly (tolerance 0:
indices, masks and counts are integers), on inputs made from a numpy seed:

  - the compaction: one CTA per (chunk of 256 words, block) tile, a warp
    per 32 words. A hit's position is the block's offset, plus the counts
    of the chunks before its tile, plus the hits of the warps before its
    warp in the tile, plus the warp's exclusive scan of the words'
    popcounts, plus popc(word & lanemask_lt(j)) for bit j. Held against
    masked_collect_multi and compact_indices with the cap at B (the port
    has no cap), at hit shares 0, 1/B, 0.001, 0.5, 1 - 1/B and 1, with
    offsets of -1 beside partial blocks, at B not a multiple of 32 or 8192;
  - the class word: the row rule (a target outside 0..255 matches nothing
    and its row is not read), lane L's 16 bytes of each 512-point span of
    a warp's 1024, tested four at a time as __vcmpeq4 against the target
    replicated into a word, the four byte masks gathered into 16 bits, the
    lane pairing by __shfl_xor_sync and the hand-round of each lane's word,
    the valid bits below n_valid; held against class_mask_jnp_multi at
    targets -1, 0, 6, 255, 256 and 2^31 - 1 and n_valid 0, 1, B - 1 and B.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu.ops import compact as JC
from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch.ops import compact as TC
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from test_torch_time_planes import to_words

I32 = np.iinfo(np.int32)
CHUNK_WORDS, WARPS = 256, 8  # csrc/collect.cuh kChunkWords, block_count.cuh kWarps


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def popc(x) -> np.ndarray:
    """Popcount of each u32."""
    x = np.asarray(x, np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1, dtype=np.int64)


# ---------------------------------------------------------------- compaction


def compact_model(words, chunks, offsets, total: int) -> np.ndarray:
    """(total,) int32 as compact_bits_kernel places the hits of the blocks
    with an offset: words (K, n_words) u32, chunks (K, n_chunks) hit counts.
    Every position is written exactly once."""
    k_rows, n_words = words.shape
    n_chunks = chunks.shape[1]
    out = np.full(total, -1, np.int64)
    lanes = np.arange(32, dtype=np.uint32)
    below = (np.uint32(1) << lanes) - np.uint32(1)  # lanemask_lt of lane j
    for k in range(k_rows):
        base = int(offsets[k])
        if base < 0:
            continue
        for c in range(n_chunks):
            prior = int(chunks[k, :c].sum())
            tile = np.zeros(CHUNK_WORDS, np.uint32)
            part = words[k, c * CHUNK_WORDS:(c + 1) * CHUNK_WORDS]
            tile[:len(part)] = part
            n = popc(tile).reshape(WARPS, 32)
            warp_before = np.concatenate([[0], np.cumsum(n.sum(1))[:-1]])
            at = (warp_before[:, None] + np.cumsum(n, 1) - n).reshape(-1)  # per word
            # the warp walks its words with hits; lane j takes bit j
            bit = (tile[:, None] >> lanes) & np.uint32(1)
            w, j = np.nonzero(bit)
            pos = base + prior + at[w] + popc(tile[w] & below[j])
            assert (out[pos] == -1).all()
            out[pos] = 32 * (c * CHUNK_WORDS + w) + j
    assert (out >= 0).all()
    return out.astype(np.int32)


def share_rows(rng, shares, b: int) -> np.ndarray:
    """(K, B) bool, block k hit at shares[k]; 1/B and 1 - 1/B exactly one
    hit and one miss."""
    mask = np.zeros((len(shares), b), bool)
    for k, s in enumerate(shares):
        if s == 1 / b:
            mask[k, rng.integers(0, b)] = True
        elif s == 1 - 1 / b:
            mask[k] = True
            mask[k, rng.integers(0, b)] = False
        else:
            mask[k] = rng.random(b) < s
    return mask


def offsets_of(counts, rule: str, b: int) -> np.ndarray:
    """Offsets as the collect path gives them (partial blocks only), as the
    density path does (every block with a hit), or with every other
    partial block skipped (-1)."""
    offsets = np.full(len(counts), -1, np.int64)
    total, partial = 0, 0
    for k, c in enumerate(counts):
        take = 0 < c < b if rule == "collect" else c > 0
        if rule == "mixed" and 0 < c < b:
            take = partial % 2 == 0
            partial += 1
        if take:
            offsets[k], total = total, total + int(c)
    return offsets


SHARES = "0, 1/B, 0.001, 0.5, 1 - 1/B, 1"


@pytest.mark.parametrize("b", [200, 8192 + 100, 2 * 8192 + 40 + 3])
@pytest.mark.parametrize("rule", ["collect", "density", "mixed"])
def test_compact_placement_matches_jax(b, rule):
    """The placement model equals masked_collect_multi and compact_indices
    (cap = B) block by block, and the port's plain compaction, at every
    hit share of SHARES twice over (each block a partial one beside
    skipped ones)."""
    rng = np.random.default_rng(b + len(rule))
    shares = [0, 1 / b, 0.001, 0.5, 1 - 1 / b, 1] * 2
    mask = share_rows(rng, shares, b)
    counts = mask.sum(1)
    offsets = offsets_of(counts, rule, b)
    total = int(counts[offsets >= 0].sum())
    bits = TP.pack_mask_bits(torch.from_numpy(mask))
    words = bits.bits.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, to_words(mask))
    chunks = bits.chunks.numpy()
    np.testing.assert_array_equal(chunks.sum(1), counts)
    got = compact_model(words, chunks, offsets, total)

    j_counts, j_idx = JC.masked_collect_multi(jnp.asarray(mask), cap=b)
    j_counts, j_idx = np.asarray(j_counts), np.asarray(j_idx)
    np.testing.assert_array_equal(j_counts, counts)
    for k in np.nonzero(offsets >= 0)[0]:
        o, c = offsets[k], counts[k]
        np.testing.assert_array_equal(got[o:o + c], j_idx[k, :c])
        one, n = JC.compact_indices(jnp.asarray(mask[k]), cap=b)
        assert int(n) == c
        np.testing.assert_array_equal(got[o:o + c], np.asarray(one)[:c])
    plain = TC.compact_bits(bits.bits, bits.chunks, torch.from_numpy(offsets), total, b)
    np.testing.assert_array_equal(plain.numpy(), got)


def test_compact_placement_last_partial_word():
    """Hits only in a block's last, partial word (B % 32 != 0), one hit in
    a block, and all rows but one: the model places them as nonzero does."""
    b = 3 * 8192 + 45
    mask = np.zeros((3, b), bool)
    mask[0, b - 13:] = True  # the last word holds rows 32w..B-1: 13 of them
    mask[1, 8192 * 2 + 7] = True
    mask[2] = True
    mask[2, 5] = False
    counts = mask.sum(1)
    offsets = np.array([0, counts[0], counts[0] + 1], np.int64)
    bits = TP.pack_mask_bits(torch.from_numpy(mask))
    got = compact_model(bits.bits.numpy().view(np.uint32), bits.chunks.numpy(), offsets,
                        int(counts.sum()))
    np.testing.assert_array_equal(got, np.nonzero(mask)[1])
    j_counts, j_idx = JC.masked_collect_multi(jnp.asarray(mask), cap=b)
    np.testing.assert_array_equal(got[:13], np.asarray(j_idx)[0, :13])


def test_compact_model_positions_per_word():
    """Within a word, lane j's position is popc(word & lanemask_lt(j)):
    consecutive hits of one word land on consecutive positions."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (1, 300), dtype=np.uint64).astype(np.uint32)
    words[0, 17] = 0
    words[0, 40] = 0xFFFFFFFF
    chunks = np.array([[popc(words[0, :256]).sum(), popc(words[0, 256:]).sum()]])
    total = int(chunks.sum())
    got = compact_model(words, chunks, np.array([0]), total)
    mask = ((words[0][:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    np.testing.assert_array_equal(got, np.nonzero(mask.reshape(-1))[0])


# ---------------------------------------------------------------- class word


def equal_nibble(w, rep) -> np.ndarray:
    """mask_bits.cu equal_nibble: bit i when byte i of w equals byte i of
    rep; __vcmpeq4 gives 0xff at each equal byte, & 0x08040201 keeps bit i
    of byte i, and the multiply adds the four bytes into the top byte."""
    w, rep = np.asarray(w, np.uint32), np.asarray(rep, np.uint32)
    m = np.zeros(np.broadcast(w, rep).shape, np.uint32)
    for i in range(4):
        eq = ((w >> np.uint32(8 * i)) & np.uint32(0xFF)) == ((rep >> np.uint32(8 * i)) &
                                                               np.uint32(0xFF))
        m |= eq.astype(np.uint32) * np.uint32(0xFF << (8 * i))
    return (((m & np.uint32(0x08040201)).astype(np.uint64) * 0x01010101) % 2**32 >> 24).astype(
        np.uint32)


def class_row(t: int, nv: int, b: int) -> tuple[int, int]:
    """ClassRawTiles.row: the target replicated into a word, and the row's
    nv, 0 for a target outside 0..255."""
    return (t * 0x01010101) % 2**32, min(max(nv, 0), b) if 0 <= t <= 255 else 0


def class_rows(cls, targets, nvs):
    """The row rule of every row: (rep (K,) u32, nv (K,), valid words)."""
    b = cls.shape[1]
    rows = [class_row(int(t), int(nv), b) for t, nv in zip(targets, nvs)]
    rep = np.array([r[0] for r in rows], np.uint32)
    nv = np.array([r[1] for r in rows])
    return rep, nv, to_words(np.arange(b)[None, :] < nv[:, None])


def gather_words(nib) -> np.ndarray:
    """(..., spans, 32) 4-bit results of lane L for points 128 s + 4 L .. + 3
    -> (..., 32) lane L's word: three __shfl_xor_sync OR lanes 8g..8g+7
    into word 4 s + g, and __shfl_sync from lane 8 (L & 3) at s = L >> 2."""
    lanes = np.arange(32)
    mine = np.zeros(nib.shape[:-2] + (32,), np.uint32)
    for s in range(8):
        v = nib[..., s, :] << (4 * (lanes & 7)).astype(np.uint32)
        for m in (1, 2, 4):
            v = v | v[..., lanes ^ m]
        mine = np.where(lanes >> 2 == s, v[..., 8 * (lanes & 3)], mine)
    return mine


def class_words_wide(cls, targets, nvs) -> np.ndarray:
    """(K, words) u32 hit words as ClassRawTiles<true> makes them (B % 16 ==
    0, rows on 16-byte boundaries): lane L's uint4 of each 512-point span,
    loaded where its 16 bytes start below nv, its 16 bits, the lane pairing
    and the hand-round; ANDed with the valid bits."""
    k_rows, b = cls.shape
    rep, nv, valid = class_rows(cls, targets, nvs)
    n_warps = -(-b // 1024)
    data = np.zeros((k_rows, 1024 * n_warps), np.uint8)
    for k in range(k_rows):
        data[k, :-(-nv[k] // 16) * 16] = cls[k, :-(-nv[k] // 16) * 16]
    # warp, span s, lane L, the four words of lane L's uint4
    quads = data.reshape(k_rows, n_warps, 2, 32, 16).view("<u4")
    nib = equal_nibble(quads, rep[:, None, None, None, None])
    half = nib[..., 0] | nib[..., 1] << 4 | nib[..., 2] << 8 | nib[..., 3] << 12
    lanes = np.arange(32)
    other = half[..., lanes ^ 1]
    pair = np.where(lanes & 1, other | half << 16, half | other << 16).astype(np.uint32)
    got = pair[..., 2 * (lanes & 15)]  # (K, warp, s, lane)
    mine = np.where(lanes >> 4 == 0, got[:, :, 0], got[:, :, 1])
    return mine.reshape(k_rows, 32 * n_warps)[:, :-(-b // 32)] & valid


def class_words_narrow(cls, targets, nvs, a: int) -> np.ndarray:
    """(K, words) u32 hit words as ClassRawTiles<false> makes them for rows
    a bytes past a 4-byte boundary: the row's 4-byte words (the a bytes
    before the row hold the target, so that a wrong shift would show),
    loaded where they hold a byte below nv, lane L's word of each 128-point
    span funnel-shifted with lane L + 1's (lane 31 with lane 0's of the next
    span), __vcmpeq4, the nibbles gathered into words; ANDed with the valid
    bits."""
    k_rows, b = cls.shape
    rep, nv, valid = class_rows(cls, targets, nvs)
    n_warps = -(-b // 1024)
    lanes = np.arange(32)
    out = np.zeros((k_rows, 32 * n_warps), np.uint32)
    for k in range(k_rows):
        buf = np.full(1024 * n_warps + 8, rep[k] & 0xFF, np.uint8)
        buf[a:a + b] = cls[k]
        words = buf[:len(buf) // 4 * 4].view("<u4")
        for w in range(n_warps):
            q = 256 * w + 32 * np.arange(9)[:, None] + lanes  # (9 spans, lanes)
            x = np.where(4 * q < nv[k] + a, words[np.minimum(q, len(words) - 1)], 0)
            x[8, 1:] = 0  # only lane 0 loads the word after the warp's bytes
            x = x.astype(np.uint64)
            # lane L + 1's word, or lane 0's of the next span for lane 31
            hi = np.concatenate([x[:8, 1:], x[1:9, :1]], axis=1)
            v = ((hi << np.uint64(32) | x[:8]) >> np.uint64(8 * a)) & np.uint64(0xFFFFFFFF)
            nib = equal_nibble(v.astype(np.uint32), rep[k])
            out[k, 32 * w:32 * w + 32] = gather_words(nib)
    return out[:, :-(-b // 32)] & valid


TARGETS = (-1, 0, 6, 255, 256, I32.max)


def class_case(rng, b: int):
    """Bytes mostly 0, 1, 6, 254 and 255; one row per (target, n_valid) of
    TARGETS x (0, 1, B - 1, B), and two rows at n_valid 33 and B // 2."""
    pal = np.array([0, 1, 6, 254, 255], np.uint8)
    rows = [(t, nv) for t in TARGETS for nv in (0, 1, b - 1, b)] + [(6, 33), (0, b // 2)]
    cls = np.where(rng.random((len(rows), b)) < 0.7, pal[rng.integers(0, 5, (len(rows), b))],
                   rng.integers(0, 256, (len(rows), b))).astype(np.uint8)
    targets = np.array([r[0] for r in rows], np.int32)
    nvs = np.array([r[1] for r in rows], np.int32)
    return cls, targets, nvs


@pytest.mark.parametrize("b", [1024, 2048 + 16, 8192 + 32 * 7, 200 + 3, 4100])
def test_class_word_matches_jax(b):
    """The word model equals class_mask_jnp_multi, the port's plain mask and
    its BitMask at every target and n_valid edge; a target outside 0..255
    matches nothing."""
    rng = np.random.default_rng(b)
    cls, targets, nvs = class_case(rng, b)
    want = np.asarray(P.class_mask_jnp_multi(jnp.asarray(cls), jnp.asarray(targets),
                                             jnp.asarray(nvs)))
    plain = TP.class_mask_multi(*_t(cls, targets, nvs))
    np.testing.assert_array_equal(plain.numpy(), want)
    words = to_words(want)
    if b % 16 == 0:
        np.testing.assert_array_equal(class_words_wide(cls, targets, nvs), words)
    for a in range(4):
        np.testing.assert_array_equal(class_words_narrow(cls, targets, nvs, a), words)
    bits = TP.class_mask_bits(*_t(cls, targets, nvs))
    np.testing.assert_array_equal(bits.bits.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(bits.counts.numpy(), want.sum(1))
    for t, nv, row in zip(targets, nvs, want):
        if not 0 <= t <= 255 or nv == 0:
            assert not row.any()
        elif nv >= b - 1:
            assert row.any()  # every in-range target is among the bytes


def test_equal_nibble_gathers_every_byte_pattern():
    """The SWAR gather over all 16 patterns of equal bytes, against every
    target byte: bit i is set exactly when byte i equals the target."""
    for t in (0, 6, 255):
        other = (t + 1) % 256
        for pattern in range(16):
            w = sum((t if pattern >> i & 1 else other) << (8 * i) for i in range(4))
            assert int(equal_nibble(w, t * 0x01010101)) == pattern


def test_class_row_rule():
    """A target outside 0..255 leaves nv 0 (nothing read); 0 and 255 keep
    the row; nv is clamped into [0, B]."""
    assert class_row(-1, 100, 200)[1] == 0
    assert class_row(256, 100, 200)[1] == 0
    assert class_row(I32.max, 100, 200)[1] == 0
    assert class_row(0, 300, 200) == (0, 200)
    assert class_row(255, -4, 200) == (0xFFFFFFFF, 0)

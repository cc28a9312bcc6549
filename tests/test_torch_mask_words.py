"""The word rules of the raw GPS-time mask and the dictionary class mask, on
the CPU.

Both collect masks run on the persistent tile loop of csrc/collect.cuh: a
row rule once a block (nv 0 where no point can match, so the block's
columns are never read) and a 32-point mask word. This file holds both
rules against the JAX package and the port's plain versions, exactly
(tolerance 0: masks are bits), on inputs made from a numpy seed:

  - the dictionary word (bbox_planes.cuh DictTiles): the target code
    clamped into [0, 2^k - 1] as one axis of the box test with lo = hi =
    the code, a miss (len(dict), or any code outside the column) setting
    nv 0, and the one-column borrow chains of test_torch_time_planes.py's
    bit-level model, at every code 0..2^k and len(dict);
  - the raw time word (mask_bits.cu TimeRawTiles): in_time_range on the
    signed (hi, lo) words, a warp's 32 words made together (lane L four
    points of each 128-point span, from one 16-byte load of th and one of
    tl; three xor shuffles OR eight lanes' 4-bit results into a word and
    one shuffle hands each lane its own), the valid bits below nv and an
    empty range skipping its row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from test_torch_time_planes import bit_chain, byte_chain, column_planes, to_words, tops_to_bits

I32 = np.iinfo(np.int32)
NV_EDGES = (0, 1, 31, 32, 33)  # then B - 1 and B


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def nv_cycle(b: int, k_rows: int) -> np.ndarray:
    """n_valid at every edge of a word: 0, 1, 31, 32, 33, B - 1, B, in turn."""
    edges = [*NV_EDGES, b - 1, b]
    return np.array([min(edges[j % len(edges)], b) for j in range(k_rows)], np.int32)


def valid_words(nv, b: int) -> np.ndarray:
    """(K, words) u32: bit i of word w set when 32w + i < nv."""
    return to_words(np.arange(b)[None, :] < np.asarray(nv)[:, None])


# ---------------------------------------------------------------- dictionary


def dict_row(t: int, k: int, nv: int, b: int) -> tuple[int, int, int]:
    """DictTiles.row: box_axis's clamp of [t, t] into [0, 2^k - 1], and the
    row's nv, 0 when the clamped range is empty."""
    lo, hi = max(t, 0), min(t, (1 << k) - 1)
    return lo, hi, min(max(nv, 0), b) if lo <= hi else 0


def dict_words(cp, targets, nvs, k: int, b: int) -> np.ndarray:
    """(K, words) u32 hit words as DictTiles.word makes them: the chains of
    axis_word_nb over the code planes, ANDed with the valid bits."""
    rows = [dict_row(int(t), k, int(nv), b) for t, nv in zip(targets, nvs)]
    # the clamped bounds as the kernel holds them, unsigned
    lo = np.array([r[0] & 0xFFFFFFFF for r in rows], np.uint32)
    hi = np.array([r[1] & 0xFFFFFFFF for r in rows], np.uint32)
    x, d = column_planes(cp, k, b)
    n_words = -(-b // 32)
    ok_lo = ok_hi = np.full((len(rows), n_words), 0xFFFFFFFF, np.uint32)
    if x:  # k = 8: one byte plane, no bit plane
        zero = np.zeros((len(rows), n_words, 8), np.uint32)
        nl, nh = byte_chain(x, lo, hi, zero, zero, False)
        ok_lo, ok_hi = tops_to_bits(nl), tops_to_bits(nh)
    ok_lo, ok_hi = bit_chain(d, k // 8, lo, hi, ok_lo, ok_hi)
    return ok_lo & ok_hi & valid_words([r[2] for r in rows], b)


def dict_case(rng, k: int, b: int):
    """Codes of a dictionary of n entries at k bits (n < 2^k where k
    allows, so that an in-range code no point carries is a target too),
    and one row per target: every code 0..2^k, then len(dict), -1 and 300."""
    n = {0: 1, 1: 2, 2: 3, 4: 11, 8: 200}[k]
    targets = np.array([*range((1 << k) + 1), n, -1, 300], np.int32)
    codes = rng.integers(0, n, (len(targets), b)).astype(np.uint8)
    cp = np.zeros((len(targets), host.packed_row_width(k, b)), np.uint8)
    if k:
        for j, row in enumerate(codes):
            host.pack_bits_into(cp[j], row, k, 0, b)
    return cp, codes, targets, nv_cycle(b, len(targets))


@pytest.mark.parametrize("k, b", [(0, 200), (1, 200), (2, 200), (4, 200), (8, 200),
                                  (8, 2**13 + 3)])
def test_dict_word_matches_jax(k, b):
    """The row rule and the chain model equal the JAX package's mask, the
    port's plain mask and its BitMask, at every target code."""
    rng = np.random.default_rng(100 * k + b)
    cp, codes, targets, nvs = dict_case(rng, k, b)
    want = np.asarray(P.class_mask_dict_jnp_multi(*_j(cp, targets, nvs), k, b))
    np.testing.assert_array_equal(want, (codes == targets[:, None]) &
                                  (np.arange(b) < nvs[:, None]))
    plain = TP.class_mask_dict_multi(*_t(cp, targets, nvs), k, b)
    np.testing.assert_array_equal(plain.numpy(), want)
    words = dict_words(cp, targets, nvs, k, b)
    np.testing.assert_array_equal(words, to_words(want))
    bits = TP.class_mask_bits_dict(*_t(cp, targets, nvs), k, b)
    np.testing.assert_array_equal(bits.bits.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(bits.counts.numpy(), want.sum(1))
    for t, nv, row in zip(targets, nvs, want):
        if not 0 <= t < 1 << k or nv == 0:
            assert not row.any()  # a skipped row
    assert want[1 << k :].sum() == 0  # 2^k, len(dict) (a code no point has), -1, 300


def test_dict_row_clamps_a_miss_to_an_empty_range():
    """A miss code above the column (len(dict) can exceed 2^k - 1) and a
    negative code leave nv 0; an in-range code no point carries does not."""
    assert dict_row(4, 2, 100, 200)[2] == 0
    assert dict_row(-1, 8, 100, 200)[2] == 0
    assert dict_row(3, 2, 100, 200) == (3, 3, 100)
    assert dict_row(0, 0, 300, 200) == (0, 0, 200)
    assert dict_row(1, 0, 300, 200)[2] == 0


# ---------------------------------------------------------------- raw time


def in_time_range(th, tl, q) -> np.ndarray:
    """predicates.cuh in_time_range: q0 <= (th, tl) < q1 lexicographically,
    signed int32, q of shape (K, 4) against (K, B) words."""
    q = q[:, :, None]
    ge = (th > q[:, 0]) | ((th == q[:, 0]) & (tl >= q[:, 1]))
    lt = (th < q[:, 2]) | ((th == q[:, 2]) & (tl < q[:, 3]))
    return ge & lt


def warp_words(nibbles) -> np.ndarray:
    """TimeRawTiles' wide words, lane by lane: nibbles[..., s, L] is lane
    L's 4-bit result for points 128 s + 4 L .. + 3 of a warp's 1024; three
    __shfl_xor_sync OR the nibbles of lanes 8g..8g+7 into word 4 s + g, and
    __shfl_sync from lane 8 (L & 3) gives lane L its word when s = L >> 2.
    Returns (..., 32) u32: lane L's word."""
    lanes = np.arange(32)
    mine = np.zeros(nibbles.shape[:-2] + (32,), np.uint32)
    for s in range(8):
        v = nibbles[..., s, :] << (4 * (lanes & 7)).astype(np.uint32)
        for m in (1, 2, 4):
            v = v | v[..., lanes ^ m]
        got = v[..., 8 * (lanes & 3)]
        mine = np.where(lanes >> 2 == s, got, mine)
    return mine


def time_raw_words(ths, tls, qs, nvs) -> np.ndarray:
    """(K, words) u32 hit words as TimeRawTiles makes them on its wide path:
    the row's nv (0 for an empty range), a warp's 32 words from its lanes'
    4-point results (warp_words), ANDed with the valid bits."""
    k_rows, b = ths.shape
    some = (qs[:, 0] < qs[:, 2]) | ((qs[:, 0] == qs[:, 2]) & (qs[:, 1] < qs[:, 3]))
    nv = np.where(some, np.clip(nvs, 0, b), 0)
    n_warps = -(-b // 1024)
    hit = np.zeros((k_rows, 1024 * n_warps), bool)
    hit[:, :b] = in_time_range(ths, tls, qs)
    points = hit.reshape(k_rows, n_warps, 8, 32, 4)  # warp, span s, lane L, point i
    nibbles = (points * (1 << np.arange(4))).sum(-1).astype(np.uint32)
    words = warp_words(nibbles).reshape(k_rows, 32 * n_warps)[:, : -(-b // 32)]
    return words & valid_words(nv, b)


def time_raw_case(rng, b: int, k_rows: int = 28):
    """Words at the sign boundary (hi -1 and 0 beside INT32_MIN and
    INT32_MAX) among random ones; queries: the boundary ranges [(-1,
    INT32_MIN), (0, INT32_MIN)) and [(0, INT32_MIN), (0, 0)), equal hi words,
    start == end, start > end, the whole int32 range, two of the row's
    points; n_valid at every edge of a word in turn."""
    pal = np.array([I32.min, I32.min + 1, -2, -1, 0, 1, I32.max - 1, I32.max], np.int64)
    ths = np.where(rng.random((k_rows, b)) < 0.6, pal[rng.integers(0, 8, (k_rows, b))],
                   rng.integers(I32.min, I32.max, (k_rows, b), endpoint=True)).astype(np.int32)
    tls = np.where(rng.random((k_rows, b)) < 0.6, pal[rng.integers(0, 8, (k_rows, b))],
                   rng.integers(I32.min, I32.max, (k_rows, b), endpoint=True)).astype(np.int32)
    kinds = [[-1, I32.min, 0, I32.min], [0, I32.min, 0, 0], [-1, 0, -1, I32.max],
             [5, 7, 5, 7], [0, 1, -1, 5], [I32.min, I32.min, I32.max, I32.max],
             [-1, I32.max, 0, I32.min]]
    qs = np.zeros((k_rows, 4), np.int64)
    for j in range(k_rows):
        if j < 2 * len(kinds):
            qs[j] = kinds[j % len(kinds)]
        else:
            a, c = sorted(rng.integers(0, b, 2))
            qs[j] = [ths[j, a], tls[j, a], ths[j, c], tls[j, c]]
    nvs = nv_cycle(b, k_rows)
    nvs[0], nvs[7] = b, 33  # the boundary ranges over many points
    return ths, tls, qs.astype(np.int32), nvs


@pytest.mark.parametrize("b", [200, 4100, 2**13 + 64])
def test_time_raw_word_matches_jax(b):
    """The word rule equals the JAX package's mask, the port's plain mask
    and its BitMask; an empty range matches nothing, and the sign
    boundary ranges take exactly their hi word."""
    rng = np.random.default_rng(b)
    ths, tls, qs, nvs = time_raw_case(rng, b)
    want = np.asarray(P.time_mask_jnp_multi(*_j(ths, tls, qs, nvs)))
    plain = TP.time_mask_multi(*_t(ths, tls, qs, nvs))
    np.testing.assert_array_equal(plain.numpy(), want)
    words = time_raw_words(ths, tls, qs, nvs)
    np.testing.assert_array_equal(words, to_words(want))  # = the narrow path's ballots
    bits = TP.time_mask_bits(*_t(ths, tls, qs, nvs))
    np.testing.assert_array_equal(bits.bits.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(bits.counts.numpy(), want.sum(1))
    valid = np.arange(b)[None, :] < nvs[:, None]
    for j in (0, 7):  # [(-1, INT32_MIN), (0, INT32_MIN)): hi word -1 exactly
        np.testing.assert_array_equal(want[j], (ths[j] == -1) & valid[j])
    for j in (3, 4, 10, 11):  # start == end, start > end
        assert not want[j].any()
    # the whole int32 range: every valid point but (INT32_MAX, INT32_MAX)
    np.testing.assert_array_equal(want[5], valid[5] & ((ths[5] != I32.max) | (tls[5] != I32.max)))


def test_warp_words_hand_each_lane_its_word():
    """The shuffles of warp_words, on random nibbles: lane L ends with bits
    4j..4j+3 of word L equal to nibble (span L >> 2, lane 8 (L & 3) + j)."""
    rng = np.random.default_rng(9)
    nibbles = rng.integers(0, 16, (5, 8, 32)).astype(np.uint32)
    got = warp_words(nibbles)
    for lane in range(32):
        for j in range(8):
            np.testing.assert_array_equal((got[:, lane] >> np.uint32(4 * j)) & np.uint32(15),
                                          nibbles[:, lane >> 2, 8 * (lane & 3) + j])

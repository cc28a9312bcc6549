"""The packed GPS-time test as csrc/time_planes.cuh does it, on the CPU.

The two packed time kernels (time_count_packed, mask_time_packed) rebuild
no word: they test one range on the W = k_hi + k_lo bit number
N = u(H) * 2^k_lo + u(L), with bounds that each row computes once from its
query words, by two borrow chains over the planes as they lie. This file
holds that design against the reference, exactly (tolerance 0: masks are
bits):

  - the bound rule, written here with Python ints, against the port's plain
    version (time_mask_packed_multi) and the JAX package's
    time_mask_packed_jnp_multi (plain jnp, no Pallas), on blocks packed by
    the host's packer, with query words at every edge;
  - a bit-level model of the kernel's chains (numpy uint32, operation for
    operation: byte steps four points a lane, the gather into point words,
    the bit steps, the spread back to per-byte borrows, the flipped top
    byte at 32 bits) against the rule at every width pair 0..32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.ops import predicate as TP

I32 = np.iinfo(np.int32)
B = 200  # a multiple of 8 (bit planes) but not of 32: the last word is partial
WIDTHS = [(0, 0), (4, 12), (20, 32), (32, 4), (0, 32), (32, 32), (28, 28), (3, 17)]
CASES = ["edges", "equal_hi", "empty", "full", "points"]

# ---------------------------------------------------------------- the rule


def key(v: int, k: int) -> int:
    """u(v): v below 32 bits, v ^ 2^31 read unsigned at 32."""
    return ((v & 0xFFFFFFFF) ^ 0x80000000) if k == 32 else v


def fold(v: int, k: int) -> int:
    """c(v): a lo word clamped into [0, 2^k] below 32 bits, u(v) at 32."""
    return key(v, 32) if k == 32 else min(max(v, 0), 1 << k)


def row_bounds(q, kh: int, kl: int) -> tuple[int, int]:
    """[max(Q0, 0), min(Q1 - 1, 2^W - 1)] of one row: empty when lo > hi."""
    q0 = key(int(q[0]), kh) * 2**kl + fold(int(q[1]), kl)
    q1 = key(int(q[2]), kh) * 2**kl + fold(int(q[3]), kl)
    return max(q0, 0), min(q1 - 1, 2 ** (kh + kl) - 1)


def rule_mask(ths, tls, qs, nvs, widths) -> np.ndarray:
    """(K, B) bool: the bound rule on the unpacked int32 words."""
    kh, kl = widths
    uh = ths.view(np.uint32).astype(np.uint64)
    ul = tls.view(np.uint32).astype(np.uint64)
    if kh == 32:
        uh ^= np.uint64(1 << 31)
    if kl == 32:
        ul ^= np.uint64(1 << 31)
    n = (uh << np.uint64(kl)) | ul  # W <= 64 bits
    out = np.zeros(ths.shape, bool)
    for j, q in enumerate(qs):
        lo, hi = row_bounds(q, kh, kl)
        if lo <= hi:
            out[j] = (n[j] >= np.uint64(lo)) & (n[j] <= np.uint64(hi))
        out[j, max(int(nvs[j]), 0) :] = False
    return out


# ---------------------------------------------------------------- the chains

TOPS, ONES = np.uint32(0x80808080), np.uint32(0x01010101)


def byte_lanes(plane) -> np.ndarray:
    """(K, B) u8 byte plane -> (K, words, 8) u32 lanes of 4 points each."""
    k_rows, b = plane.shape
    padded = np.zeros((k_rows, -(-b // 32) * 32), np.uint8)
    padded[:, :b] = plane
    return padded.view("<u4").reshape(k_rows, -1, 8)


def bit_words(plane) -> np.ndarray:
    """(K, B / 8) u8 bit plane -> (K, words) u32, bit i = point 32w + i."""
    k_rows, nb = plane.shape
    padded = np.zeros((k_rows, -(-nb // 4) * 4), np.uint8)
    padded[:, :nb] = plane
    return padded.view("<u4")


def column_planes(stack, k: int, b: int):
    """A column's byte planes as lanes and its bit planes as words."""
    nbytes, nbits = k // 8, k % 8
    x = [byte_lanes(stack[:, p * b : (p + 1) * b]) for p in range(nbytes)]
    off, bb = nbytes * b, b // 8
    d = [bit_words(stack[:, off + q * bb : off + (q + 1) * bb]) for q in range(nbits)]
    return x, d


def byte_chain(x, lo, hi, bl, bh, signed_top: bool):
    """bbox_planes.cuh byte_chain: the top bits of each byte after the last
    plane; lo, hi (K,) u32 column bounds, bl, bh borrows into the first."""
    nl = nh = None
    for p, v in enumerate(x):
        if signed_top and p == 3:
            v = v ^ TOPS
        cl = (((lo >> np.uint32(8 * p)) & np.uint32(0xFF)) * ONES)[:, None, None]
        ch = (((hi >> np.uint32(8 * p)) & np.uint32(0xFF)) * ONES)[:, None, None]
        tl = (v | TOPS) - (cl & ~TOPS) - bl
        th = (ch | TOPS) - (v & ~TOPS) - bh
        nl = (v & tl) | (~cl & (v | tl))
        nh = (~v & th) | (ch & (~v | th))
        bl = (~nl >> np.uint32(7)) & ONES
        bh = (~nh >> np.uint32(7)) & ONES
    return nl, nh


def tops_to_bits(m) -> np.ndarray:
    bits = np.zeros(m.shape[:2], np.uint32)
    for j in range(8):
        four = (((m[..., j] >> np.uint32(7)) & ONES) * np.uint32(0x01020408)) >> np.uint32(24)
        bits |= four << np.uint32(4 * j)
    return bits


def word_borrows(ok) -> np.ndarray:
    borrowed = ~ok
    return np.stack([((borrowed >> np.uint32(4 * j)) & np.uint32(0xF)) * np.uint32(0x00204081)
                     & ONES for j in range(8)], -1)


def bit_chain(d, nbytes, lo, hi, ok_lo, ok_hi):
    for q, v in enumerate(d):
        bl = np.where((lo >> np.uint32(8 * nbytes + q)) & np.uint32(1), np.uint32(0xFFFFFFFF),
                      np.uint32(0))[:, None]
        bh = np.where((hi >> np.uint32(8 * nbytes + q)) & np.uint32(1), np.uint32(0xFFFFFFFF),
                      np.uint32(0))[:, None]
        ok_lo = (v & ok_lo) | (~bl & (v | ok_lo))
        ok_hi = (~v & ok_hi) | (bh & (~v | ok_hi))
    return ok_lo, ok_hi


def chain_words(thp, tlp, qs, nvs, widths, b) -> np.ndarray:
    """(K, words) u32 hit words as time_range_word makes them (valid bits
    applied; an empty interval's row is 0)."""
    kh, kl = widths
    k_rows = len(qs)
    bounds = [row_bounds(q, kh, kl) for q in qs]
    some = np.array([lo <= hi for lo, hi in bounds])
    lo_b = [lo if s else 0 for (lo, _), s in zip(bounds, some)]
    hi_b = [hi if s else 0 for (_, hi), s in zip(bounds, some)]
    mask = (1 << kl) - 1
    col = {
        "lo": (np.array([v & mask for v in lo_b], np.uint32),
               np.array([v & mask for v in hi_b], np.uint32)),
        "hi": (np.array([v >> kl for v in lo_b], np.uint32),
               np.array([v >> kl for v in hi_b], np.uint32)),
    }
    xl, dl = column_planes(tlp, kl, b)
    xh, dh = column_planes(thp, kh, b)
    n_words = -(-b // 32)
    zero = np.zeros((k_rows, n_words, 8), np.uint32)
    ones = np.full((k_rows, n_words), 0xFFFFFFFF, np.uint32)
    state, ok_lo, ok_hi = "fresh", ones, ones
    if xl:
        nl, nh = byte_chain(xl, *col["lo"], zero, zero, kl == 32)
        state = "byte"
    if dl:
        if state == "byte":
            ok_lo, ok_hi = tops_to_bits(nl), tops_to_bits(nh)
        ok_lo, ok_hi = bit_chain(dl, kl // 8, *col["lo"], ok_lo, ok_hi)
        state = "point"
    if xh:
        if state == "byte":
            bl, bh = (~nl >> np.uint32(7)) & ONES, (~nh >> np.uint32(7)) & ONES
        elif state == "point":
            bl, bh = word_borrows(ok_lo), word_borrows(ok_hi)
        else:
            bl = bh = zero
        nl, nh = byte_chain(xh, *col["hi"], bl, bh, kh == 32)
        state = "byte"
    if state == "byte":
        if not dh:
            words = tops_to_bits(nl & nh)
            return words & valid_words(nvs, some, b)
        ok_lo, ok_hi = tops_to_bits(nl), tops_to_bits(nh)
    ok_lo, ok_hi = bit_chain(dh, kh // 8, *col["hi"], ok_lo, ok_hi)
    return ok_lo & ok_hi & valid_words(nvs, some, b)


def to_words(mask) -> np.ndarray:
    """(K, B) bool -> (K, words) u32, bit i of word w = row 32w + i."""
    k_rows, b = mask.shape
    padded = np.zeros((k_rows, -(-b // 32) * 32), bool)
    padded[:, :b] = mask
    return np.packbits(padded, axis=-1, bitorder="little").view("<u4")


def valid_words(nvs, some, b) -> np.ndarray:
    nv = np.where(some, np.clip(nvs, 0, b), 0)
    return to_words(np.arange(b)[None, :] < nv[:, None])


# ---------------------------------------------------------------- data


def edges(k: int) -> list[int]:
    """int32 words at the ends of a k-bit residual space and beyond."""
    top = (1 << k) - 1 if k < 32 else I32.max
    vals = {I32.min, I32.max, -1, 0, 1, min(top, I32.max), min(top + 1, I32.max)}
    return sorted(vals)


def residual_palette(k: int) -> list[int]:
    if k == 32:
        return [I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max]
    top = (1 << k) - 1
    return sorted({0, min(1, top), max(top - 1, 0), top, top // 2})


def words(rng, k: int, shape) -> np.ndarray:
    """Unpacked int32 words of a k-bit column: half at the ends and the
    middle of residual space, half anywhere in it."""
    if k == 32:
        anywhere = rng.integers(I32.min, I32.max, shape, endpoint=True)
    else:
        anywhere = rng.integers(0, 1 << k, shape)
    pal = np.array(residual_palette(k), np.int64)
    picked = pal[rng.integers(0, len(pal), shape)]
    return np.where(rng.random(shape) < 0.5, picked, anywhere).astype(np.int32)


def pack(cols, k: int, b: int) -> np.ndarray:
    out = np.zeros((len(cols), host.packed_row_width(k, b)), np.uint8)
    for j, col in enumerate(cols):
        host.pack_bits_into(out[j], col, k, 0, b)
    return out


def queries(rng, case: str, ths, tls, widths, k_rows: int) -> np.ndarray:
    kh, kl = widths
    eh, el = edges(kh), edges(kl)
    qs = np.zeros((k_rows, 4), np.int64)
    for j in range(k_rows):
        i, i2 = rng.integers(0, ths.shape[1], 2)
        h = int(ths[j, i]) if rng.random() < 0.5 else int(rng.choice(eh))
        if case == "edges":  # every word at an edge
            qs[j] = [rng.choice(eh), rng.choice(el), rng.choice(eh), rng.choice(el)]
        elif case == "equal_hi":  # equal hi words, lo at each end
            lo_end = [I32.min, -1, 0, 1][j % 4]
            hi_end = [I32.max, 1 << min(kl, 31), (1 << min(kl, 31)) - 1, 0][j // 4 % 4]
            qs[j] = [h, lo_end, h, hi_end]
        elif case == "empty":  # start == end
            qs[j] = [h, rng.choice(el), h, 0]
            qs[j, 3] = qs[j, 1]
        elif case == "full":
            qs[j] = [[I32.min, I32.min, I32.max, I32.max], [0, 0, 1 << min(kh, 31), 0],
                     [-1, I32.max, I32.max, I32.max], [0, I32.min, I32.max, 0]][j % 4]
        else:  # two points of the block, in order, as the engine's query
            a, c = sorted([(int(ths[j, i]), int(tls[j, i])), (int(ths[j, i2]), int(tls[j, i2]))])
            qs[j] = [*a, *c]
    return np.clip(qs, I32.min, I32.max).astype(np.int32)


def block(rng, widths, case: str, k_rows: int = 48, b: int = B):
    kh, kl = widths
    ths, tls = words(rng, kh, (k_rows, b)), words(rng, kl, (k_rows, b))
    qs = queries(rng, case, ths, tls, widths, k_rows)
    nvs = rng.integers(0, b + 1, k_rows).astype(np.int32)
    nvs[:4] = [b, 0, 1, b - 1]
    return pack(ths, kh, b), pack(tls, kl, b), ths, tls, qs, nvs


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_bound_rule_matches_plain_and_jax(widths, case):
    """The rule on the unpacked words equals the port's plain packed mask
    and the JAX package's, and the chains equal the rule."""
    rng = np.random.default_rng(sum(widths) * 31 + CASES.index(case))
    thp, tlp, ths, tls, qs, nvs = block(rng, widths, case)
    want = rule_mask(ths, tls, qs, nvs, widths)
    plain = TP.time_mask_packed_multi(*(torch.from_numpy(a) for a in (thp, tlp, qs, nvs)),
                                      widths, B)
    np.testing.assert_array_equal(plain.numpy(), want)
    ref = P.time_mask_packed_jnp_multi(*(jnp.asarray(a) for a in (thp, tlp, qs, nvs)),
                                       widths, B)
    np.testing.assert_array_equal(np.asarray(ref), want)
    np.testing.assert_array_equal(chain_words(thp, tlp, qs, nvs, widths, B), to_words(want))
    if case == "empty":
        assert not want.any()
    if case == "full":
        assert want[0].any()  # the whole int32 range at n_valid B


@pytest.mark.parametrize("kh", range(33))
def test_chains_match_rule_at_every_width(kh):
    """Every k_lo in 0..32 beside this k_hi: the chain model's hit words
    equal the rule's mask and the port's plain packed mask."""
    for kl in range(33):
        widths = (kh, kl)
        rng = np.random.default_rng(kh * 64 + kl)
        case = CASES[(kh + kl) % len(CASES)]
        thp, tlp, ths, tls, qs, nvs = block(rng, widths, case, k_rows=24, b=104)
        want = rule_mask(ths, tls, qs, nvs, widths)
        plain = TP.time_mask_packed_multi(*(torch.from_numpy(a) for a in (thp, tlp, qs, nvs)),
                                          widths, 104)
        np.testing.assert_array_equal(plain.numpy(), want, err_msg=str(widths))
        np.testing.assert_array_equal(chain_words(thp, tlp, qs, nvs, widths, 104),
                                      to_words(want), err_msg=str(widths))


def test_word_borrows_spread_each_point_to_its_byte():
    """The spread of a point word back to per-byte borrows (bit 0 of byte i
    of lane j is point 4j + i) and the gather are inverse."""
    rng = np.random.default_rng(5)
    ok = rng.integers(0, 2**32, (3, 7), dtype=np.uint64).astype(np.uint32)
    b = word_borrows(ok)
    for j in range(8):
        for i in range(4):
            want = (~ok >> np.uint32(4 * j + i)) & np.uint32(1)
            np.testing.assert_array_equal((b[..., j] >> np.uint32(8 * i)) & np.uint32(1), want)
    assert not (b & ~ONES).any()
    np.testing.assert_array_equal(tops_to_bits(~b << np.uint32(7)), ok)

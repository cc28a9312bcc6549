"""The class counts on the persistent tile loop, on the CPU.

The u8 and word class counts (csrc/class_count.cu) and the dictionary
count (csrc/class_count_dict.cu) walk (block, chunk) tiles with
csrc/collect.cuh count_tiles and write their outputs through a per-row
64-bit ticket word (row_done: the CTAs done in its high half, their hits in
its low half). This file holds a numpy model of each rule against
the JAX package and the port's plain versions, exactly (tolerance 0: counts
are integers), on inputs made from a numpy seed:

  - the raw class count (class_tiles.cuh ClassRawTiles.hits): a warp's
    1024 points, lane L's two 16-byte loads (rows on 16-byte boundaries,
    B % 16 == 0) or its eight aligned 4-byte words and lane 0's word after
    them (any other row, a bytes past a 4-byte boundary), each tested as
    __vcmpeq4 against the target replicated into a word and counted under
    a byte mask that keeps the warp's points below n_valid; the u8 rule (a
    target outside 0..255 reads nothing) and the word rule (uint32(t) *
    0x01010101, any int32). Held against class_count_pallas_multi and
    class_count_packed_pallas_multi in interpret mode;
  - the ticket accounting: a count's tile is S chunks of one row
    (row_tiles of them a row; S = 1 makes them the chunks), the CTAs that
    touch a row in count_tiles's walk are min(row_tiles, grid), and the CTA
    that draws a row's last ticket stores its sum and leaves the workspace
    all 0, in any order of the CTAs;
  - the dictionary count: the popcount of DictTiles's word (the one-column
    chain model of test_torch_mask_words.py) against
    class_count_dict_jnp_multi, a miss included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from test_torch_collect_words import popc
from test_torch_mask_words import dict_case, dict_words

I32 = np.iinfo(np.int32)
CHUNK_WORDS = 256  # csrc/collect.cuh kChunkWords: a chunk is 8192 points
TARGETS = (0, 6, 255, -1, 256, 262, 0x01010106)
B = 1 << 14


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def vcmpeq4(w, rep) -> np.ndarray:
    """__vcmpeq4: 0xff at each byte of w equal to the same byte of rep."""
    w, rep = np.asarray(w, np.uint32), np.asarray(rep, np.uint32)
    out = np.zeros(np.broadcast(w, rep).shape, np.uint32)
    for i in range(4):
        byte = np.uint32(0xFF << (8 * i))
        out |= np.where((w & byte) == (rep & byte), byte, np.uint32(0))
    return out


def keep_bytes(n) -> np.ndarray:
    """class_tiles.cuh keep_bytes: the low n bytes of a word, n in [0, 4]."""
    n = np.clip(np.asarray(n, np.int64), 0, 4)
    return np.where(n >= 4, 0xFFFFFFFF, (1 << (8 * n)) - 1).astype(np.uint32)


def class_row(t: int, nv: int, b: int, words: bool) -> tuple[int, int]:
    """ClassRawTiles.row: the target replicated into a word, and nv (0 for
    a target outside 0..255 under the u8 rule)."""
    nv = min(max(nv, 0), b) if words or 0 <= t <= 255 else 0
    return (t * 0x01010101) % 2**32, nv


def hits_wide(row: np.ndarray, rep: int, nv: int) -> int:
    """ClassRawTiles<true>.hits summed over the warps count_tiles calls (p0
    below nv): lane L's uint4 at p0 + 512 s + 16 L, loaded below nv, its
    four words under keep_bytes(nv - i - 4c)."""
    b = len(row)
    total = 0
    for p0 in range(0, nv, 1024):
        i = p0 + 512 * np.arange(2)[:, None] + 16 * np.arange(32)[None, :]  # (s, lane)
        data = np.zeros((2, 32, 16), np.uint8)
        for s in range(2):
            for lane in range(32):
                if i[s, lane] < nv:
                    data[s, lane] = row[i[s, lane]:i[s, lane] + 16]
        quads = data.view("<u4")  # (s, lane, 4 words)
        left = (nv - i)[:, :, None] - 4 * np.arange(4)
        bits = int(popc(vcmpeq4(quads, rep) & keep_bytes(left)).sum())
        assert bits % 8 == 0
        total += bits >> 3
    assert b % 16 == 0
    return total


def hits_narrow(buf: np.ndarray, a: int, b: int, rep: int, nv: int) -> int:
    """ClassRawTiles<false>.hits summed over the warps count_tiles calls:
    the row is buf[a:a + b], a its offset past a 4-byte boundary; word q of
    buf holds row points 4q - a .. 4q - a + 3. Lane L loads words q0 + 32j
    + L (j < 8) and lane 0 word q0 + 256 where a word holds a point below
    nv, and keeps the points in [p0, min(p0 + 1024, nv))."""
    words = buf[:len(buf) // 4 * 4].view("<u4")
    lanes = np.arange(32)
    total = 0
    for p0 in range(0, nv, 1024):
        hi = min(p0 + 1024, nv)
        q = p0 // 4 + 32 * np.arange(9)[:, None] + lanes  # (j, lane)
        f = 4 * q - a
        loaded = (f < nv) & ((np.arange(9)[:, None] < 8) | (lanes == 0))
        x = np.where(loaded, words[np.minimum(q, len(words) - 1)], 0).astype(np.uint32)
        keep = keep_bytes(hi - f) & ~keep_bytes(p0 - f)
        bits = np.where(loaded, popc(vcmpeq4(x, rep) & keep), 0)
        total += int(bits.sum())
    assert total % 8 == 0
    return total >> 3


def model_counts(cls, targets, nvs, words: bool, a=None) -> np.ndarray:
    """(K,) counts as class_count.cu's kernel makes them: the wide path for
    a is None (B % 16 == 0), else the narrow path with each row a bytes
    past a 4-byte boundary (the a bytes before the row, and the bytes past
    it, hold the target's byte, so that a wrong keep mask would count)."""
    k_rows, b = cls.shape
    out = np.zeros(k_rows, np.int64)
    for k in range(k_rows):
        rep, nv = class_row(int(targets[k]), int(nvs[k]), b, words)
        if a is None:
            out[k] = hits_wide(cls[k], rep, nv)
        else:
            buf = np.full(-(-(a + b) // 1024) * 1024 + 1032, rep & 0xFF, np.uint8)
            buf[a:a + b] = cls[k]
            out[k] = hits_narrow(buf, a, b, rep, nv)
    return out


def class_case(rng, b: int):
    """One row per (target, n_valid) of TARGETS x (0, 1, B - 1, B): bytes
    mostly 0, 6, 255 and the bytes of 0x01010106's replicated word (6, 7,
    8, 9), so that the word rule's per-position bytes match somewhere."""
    pal = np.array([0, 6, 255, 7, 8, 9], np.uint8)
    rows = [(t, nv) for t in TARGETS for nv in (0, 1, b - 1, b)]
    cls = np.where(rng.random((len(rows), b)) < 0.7, pal[rng.integers(0, len(pal), (len(rows), b))],
                   rng.integers(0, 256, (len(rows), b))).astype(np.uint8)
    return cls, np.array([r[0] for r in rows], np.int32), np.array([r[1] for r in rows], np.int32)


def pallas_counts(cls, targets, nvs, words: bool) -> np.ndarray:
    """The JAX package's Pallas count (interpret mode) of rows zero-padded
    to its tile shape (nv never reaches the padding)."""
    k_rows, b = cls.shape
    tile = P.MIN_BLOCK_MULTIPLE * (4 if words else 1)
    pad = np.zeros((k_rows, -(-b // tile) * tile), np.uint8)
    pad[:, :b] = cls
    with pltpu.force_tpu_interpret_mode():
        if words:
            return np.asarray(P.class_count_packed_pallas_multi(*_j(pad.view(np.int32), targets,
                                                                    nvs)))
        return np.asarray(P.class_count_pallas_multi(*_j(pad, targets, nvs)))


@pytest.mark.parametrize("words", [False, True], ids=["u8", "words"])
def test_class_count_model_matches_pallas(words):
    """At B = 2^14 both load paths of the model (16-byte lanes; the 4-byte
    words at a = 0, as the word entry's rows are when they are off 16-byte
    boundaries, and for the u8 rule at a = 1, 2, 3) equal the Pallas count
    and the port's plain count at every target and n_valid edge."""
    rng = np.random.default_rng(14 + words)
    cls, targets, nvs = class_case(rng, B)
    want = pallas_counts(cls, targets, nvs, words)
    plain = (TP.class_count_words_kernel(*_t(cls.view(np.int32), targets, nvs)) if words
             else TP.class_count_multi_kernel(*_t(cls, targets, nvs)))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(model_counts(cls, targets, nvs, words), want)
    for a in (0,) if words else (0, 1, 2, 3):
        np.testing.assert_array_equal(model_counts(cls, targets, nvs, words, a), want)
    counts = want.reshape(len(TARGETS), 4)
    if words:  # every target is tested; 0x01010106 meets bytes 6, 7, 8, 9 in turn
        assert (counts[:, 3] > 0).all()
    else:  # outside 0..255 nothing matches
        assert counts[3:].sum() == 0 and (counts[:3, 3] > 0).all()
    assert counts[:, 0].sum() == 0


def test_class_count_model_narrow_rows_match_pallas():
    """B - 2 (rows off 16-byte boundaries, B % 4 == 2): the 4-byte path at
    every offset a past a 4-byte boundary equals the Pallas count of the
    same rows and the port's plain count."""
    rng = np.random.default_rng(12)
    b = B - 2
    cls, targets, nvs = class_case(rng, b)
    want = pallas_counts(cls, targets, nvs, False)
    np.testing.assert_array_equal(TP.class_count_multi_kernel(*_t(cls, targets, nvs)).numpy(),
                                  want)
    for a in range(4):
        np.testing.assert_array_equal(model_counts(cls, targets, nvs, False, a), want)


def test_keep_masks_drop_the_bytes_outside_the_warp():
    """The narrow path's first word holds a bytes before the row and its
    last (lane 0's ninth) a bytes of the next warp: keep_bytes(hi - f) &
    ~keep_bytes(p0 - f) keeps exactly the warp's points below nv."""
    for a in range(4):
        p0, nv = 1024, 5000
        first = 4 * (p0 // 4) - a  # the point at byte 0 of lane 0's first word
        keep = int(keep_bytes(min(p0 + 1024, nv) - first)) & ~int(keep_bytes(p0 - first))
        assert keep & 0xFFFFFFFF == (0xFFFFFFFF << (8 * a)) & 0xFFFFFFFF
        last = first + 1024  # lane 0's ninth word
        keep = int(keep_bytes(min(p0 + 1024, nv) - last)) & ~int(keep_bytes(p0 - last))
        assert keep & 0xFFFFFFFF == (1 << (8 * a)) - 1
    # a warp ending inside a word at nv: only the bytes below nv
    assert int(keep_bytes(3)) == 0x00FFFFFF and int(keep_bytes(-2)) == 0


# ---------------------------------------------------------------- tickets


def touching(k_rows: int, row_tiles: int, grid: int) -> np.ndarray:
    """(K,) the CTAs whose walk in count_tiles (tiles b, b + grid, ...)
    reaches each row: row k's tiles are k * row_tiles .. + row_tiles - 1."""
    t = np.arange(k_rows * row_tiles, dtype=np.int64)
    pairs = np.unique((t // row_tiles) * grid + t % grid)
    return np.bincount(pairs // grid, minlength=k_rows)


def tickets(k_rows: int, row_tiles: int, grid: int, rng) -> np.ndarray:
    """out as row_done leaves it: each CTA's visit of a row (its rows never
    decrease) adds (1 << 32) + its count to the row's 64-bit word with one
    atomicAdd, the CTAs in a random order; the one whose word before its add
    holds touching - 1 tickets stores the low 32 bits of the sum and zeroes
    the word. A count of 1 a tile, so out[k] must be row_tiles."""
    visits = {}
    for tile in range(k_rows * row_tiles):  # a CTA's walk, row by row
        key = (tile % grid, tile // row_tiles)
        visits[key] = visits.get(key, 0) + 1
    work = np.zeros(k_rows, np.uint64)
    out = np.full(k_rows, -7, np.int64)
    want_touching = min(row_tiles, grid)
    order = list(visits.items())
    rng.shuffle(order)
    for (_, row), count in order:
        if want_touching == 1:
            out[row] = count
            continue
        mine = np.uint64((1 << 32) | count)
        before = work[row]
        work[row] = before + mine
        if int(before) >> 32 == want_touching - 1:
            out[row] = int(before + mine) & 0xFFFFFFFF
            work[row] = 0
    assert not work.any()
    return out


@pytest.mark.parametrize("k_rows", [1, 4, 65548])
@pytest.mark.parametrize("row_tiles", [1, 3, 256])
def test_ctas_touching_a_row(k_rows, row_tiles):
    """count_tiles's touching = min(row_tiles, grid) is the number of CTAs
    whose walk reaches each row, at grids from 1 to 1,056 (every grid where
    the tiles are few, a spread where they are many)."""
    n_tiles = k_rows * row_tiles
    grids = range(1, 1057) if n_tiles <= 4096 else [
        1, 2, 3, 7, 31, 132, 255, 256, 257, 528, 1000, 1024, 1055, 1056]
    for grid in grids:
        grid = min(grid, n_tiles)  # tile_grid: no more CTAs than tiles
        np.testing.assert_array_equal(touching(k_rows, row_tiles, grid),
                                      np.full(k_rows, min(row_tiles, grid)))


@pytest.mark.parametrize("chunks_a_tile", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [96, 8192, 8192 * 3 + 40, 2**21, 2**21 - 8189])
def test_tiles_of_several_chunks_cover_each_word_once(b, chunks_a_tile):
    """count_row_tiles(B, S) tiles of S chunks: thread j of tile i takes
    words (S i + s) * 256 + j for s < S; below the row's words each is
    taken once, and the rest (past the row) read nothing."""
    n_words = -(-b // 32)
    n_chunks = -(-n_words // CHUNK_WORDS)
    row_tiles = -(-n_chunks // chunks_a_tile)  # csrc/collect.cuh count_row_tiles
    i, s, j = np.meshgrid(np.arange(row_tiles), np.arange(chunks_a_tile),
                          np.arange(CHUNK_WORDS), indexing="ij")
    w = ((i * chunks_a_tile + s) * CHUNK_WORDS + j).reshape(-1)
    np.testing.assert_array_equal(np.sort(w[w < n_words]), np.arange(n_words))
    assert (w >= n_words).sum() == row_tiles * chunks_a_tile * CHUNK_WORDS - n_words


@pytest.mark.parametrize("k_rows, row_tiles", [(1, 1), (4, 3), (4, 256), (300, 3), (65548, 1)])
def test_last_ticket_stores_each_row(k_rows, row_tiles):
    """In any order of the CTAs, every row's last ticket stores its whole
    sum and the workspace ends all 0, at grids below, at and above the
    row's tiles."""
    rng = np.random.default_rng(k_rows + row_tiles)
    for grid in (1, 2, row_tiles, row_tiles + 1, 1056):
        grid = min(grid, k_rows * row_tiles)
        np.testing.assert_array_equal(tickets(k_rows, row_tiles, grid, rng),
                                      np.full(k_rows, row_tiles))


# ---------------------------------------------------------------- dictionary


@pytest.mark.parametrize("k, b", [(0, 200), (1, 200), (2, 200), (4, 200), (8, 200),
                                  (8, 2**13 + 3), (2, 2 * 8192 + 64)])
def test_dict_count_matches_jax(k, b):
    """The popcount of DictTiles's words, row by row, equals
    class_count_dict_jnp_multi and the port's plain count at every target
    code 0..2^k, len(dict) (a miss), -1 and 300."""
    rng = np.random.default_rng(10 * k + b)
    cp, codes, targets, nvs = dict_case(rng, k, b)
    want = np.asarray(P.class_count_dict_jnp_multi(*_j(cp, targets, nvs), k, b))
    np.testing.assert_array_equal(want, ((codes == targets[:, None]) &
                                         (np.arange(b) < nvs[:, None])).sum(1))
    got = popc(dict_words(cp, targets, nvs, k, b)).sum(1)
    np.testing.assert_array_equal(got, want)
    plain = TP.class_count_dict_kernel(*_t(cp, targets, nvs), k, b)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert want[1 << k:].sum() == 0  # 2^k, len(dict) (a code no point has), -1, 300
    assert want[:1 << k].sum() > 0 or k == 0  # k = 0: code 0's row has n_valid 0

"""The port's collect pieces against the JAX package's, on the CPU.

The plain mask forms against the JAX mask functions, the plain compaction
against masked_collect_multi and compact_indices with the cap at the block
size (the port has no cap), the bit-mask layout, and one whole collect step
(predicate, counts, hit indices) per collect kind against the JAX package's
sharded_collect on a one-device mesh. Masks, counts and indices are
integers and booleans: the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu.ops import compact as JC
from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_tpu.parallel import mesh as mesh_mod
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.ops import compact as TC
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from adhoc_queries_pointclouds_torch.parallel import step
from test_torch_cuda import EDGE_WIDTHS, packed_bbox_edge_case

I32 = np.iinfo(np.int32)
WIDTHS = [0, 4, 12, 20, 28, 32]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _column(rng, k, B):
    """A column whose k-bit residual against its base spans [0, 2^k), and
    that base (0 at k == 32, where the raw words ship)."""
    if k == 32:
        return rng.integers(I32.min, I32.max, B, endpoint=True).astype(np.int32), 0
    base = int(rng.integers(-(2**30), 2**30 - (1 << k) if k < 31 else 1))
    return (base + rng.integers(0, 1 << k, B)).astype(np.int32), base


def _planes(cols, k, B):
    out = np.zeros((len(cols), host.packed_row_width(k, B)), np.uint8)
    for j, (col, base) in enumerate(cols):
        host.pack_bits_into(out[j], col, k, base, B)
    return out


def _residual_bounds(rng, cols, k):
    """Per-block residual-space (lo, hi) at about half the range, one empty
    row (lo 0, hi -1: a padding row) and one full row."""
    lo, hi = [], []
    for col, base in cols:
        a, b = np.percentile(col.astype(np.int64), sorted(rng.uniform(0, 100, 2)))
        lo.append(int(a) - base)
        hi.append(int(b) - base)
    lo, hi = np.clip(lo, I32.min, I32.max), np.clip(hi, I32.min, I32.max)
    lo[1], hi[1] = 0, -1
    lo[2], hi[2] = (I32.min, I32.max) if k == 32 else (0, (1 << k) - 1)
    return lo.astype(np.int32), hi.astype(np.int32)


def _nvs(rng, K, B):
    nvs = rng.integers(0, B + 1, K).astype(np.int32)
    nvs[0] = B
    nvs[-1] = 0
    return nvs


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("B", [1024, 1032])  # B/8 odd: rows off 8-byte boundaries
def test_bbox_mask_packed_matches_jax(w, B):
    rng = np.random.default_rng(w * 31 + B)
    K = 5
    axes = [[_column(rng, w, B) for _ in range(K)] for _ in range(3)]
    planes = [_planes(cols, w, B) for cols in axes]
    bounds = [_residual_bounds(rng, cols, w) for cols in axes]
    los = np.stack([b[0] for b in bounds], 1)
    his = np.stack([b[1] for b in bounds], 1)
    nvs = _nvs(rng, K, B)
    args = (*planes, los, his, nvs)
    ref = np.asarray(P.bbox_mask_packed_jnp_multi(*_j(*args), (w, w, w), B))
    got = TP.bbox_mask_packed_multi(*_t(*args), (w, w, w), B)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[2].sum() == nvs[2] and not ref[1].any() and not ref[-1].any()


# B = 4099: byte planes only, and the bit mask ends in a partial word
@pytest.mark.parametrize("widths, B", [(w, 4096) for w in EDGE_WIDTHS] + [
    (w, 4099) for w in EDGE_WIDTHS if all(k % 8 == 0 for k in w)])
def test_bbox_mask_packed_at_the_ends_of_residual_space_matches_jax(widths, B):
    """The mask form of the same cases, and its bit mask: the oracle of the
    card's mask_bbox_packed held to the JAX package."""
    args = packed_bbox_edge_case(widths, B)
    ref = np.asarray(P.bbox_mask_packed_jnp_multi(*_j(*args), widths, B))
    got = TP.bbox_mask_packed_multi(*_t(*args), widths, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    bits = TP.bbox_mask_bits_packed(*_t(*args), widths, B)
    np.testing.assert_array_equal(TP.unpack_mask_bits(bits.bits, B).numpy(), ref)
    np.testing.assert_array_equal(bits.counts.numpy(), ref.sum(1))
    assert ref.any() and not ref.all()


@pytest.mark.parametrize("w", WIDTHS)
def test_time_mask_packed_matches_jax(w):
    rng = np.random.default_rng(w + 7)
    K, B = 5, 1024
    his_cols = [_column(rng, w, B) for _ in range(K)]
    los_cols = [_column(rng, w, B) for _ in range(K)]
    planes = (_planes(his_cols, w, B), _planes(los_cols, w, B))
    qs = np.zeros((K, 4), np.int32)
    for j in range(K):
        (th, bh), (tl, bl) = his_cols[j], los_cols[j]
        a, b = sorted(rng.choice(B, 2, replace=False))
        q_enc = np.array([th[a], tl[a], th[b], tl[b]], np.int64)
        qs[j] = host._packed_time_query(q_enc, np.array([bh, bl], np.int64))
    nvs = _nvs(rng, K, B)
    args = (*planes, qs, nvs)
    ref = np.asarray(P.time_mask_packed_jnp_multi(*_j(*args), (w, w), B))
    got = TP.time_mask_packed_multi(*_t(*args), (w, w), B)
    np.testing.assert_array_equal(got.numpy(), ref)


# bit planes need B % 8 == 0; B = 1027 takes byte planes only
@pytest.mark.parametrize("k, B", [(1, 1024), (2, 1024), (4, 1024), (8, 1024), (8, 1027)])
def test_class_mask_dict_matches_jax(k, B):
    rng = np.random.default_rng(10 * k + B)
    K = 5
    codes = rng.integers(0, 1 << k, (K, B)).astype(np.uint8)
    cp = np.zeros((K, host.packed_row_width(k, B)), np.uint8)
    for j in range(K):
        host.pack_bits_into(cp[j], codes[j], k, 0, B)
    targets = rng.integers(0, 1 << k, K).astype(np.int32)
    targets[-2] = 1 << k  # a miss: len(dict)
    nvs = _nvs(rng, K, B)
    ref = np.asarray(P.class_mask_dict_jnp_multi(*_j(cp, targets, nvs), k, B))
    got = TP.class_mask_dict_multi(*_t(cp, targets, nvs), k, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not ref[-2].any()


@pytest.mark.parametrize("B", [1, 31, 32, 33, 8192, 8192 + 40, 3 * 8192])
def test_bit_mask_layout(B):
    rng = np.random.default_rng(B)
    mask = torch.from_numpy(rng.random((3, B)) < 0.3)
    m = TP.pack_mask_bits(mask)
    assert m.bits.shape == (3, (B + 31) // 32) and m.bits.dtype == torch.int32
    assert m.chunks.shape == (3, TP.mask_chunks(B))
    assert torch.equal(TP.unpack_mask_bits(m.bits, B), mask)
    assert torch.equal(m.counts, mask.sum(1, dtype=torch.int32))
    assert torch.equal(m.chunks.sum(1, dtype=torch.int32), m.counts)
    words = m.bits.numpy().view(np.uint32)
    for j in range(3):  # bit j of word w is row 32w + j; bits past B are 0
        rows = np.unpackbits(words[j].view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(rows[:B], mask[j].numpy())
        assert not rows[B:].any()
    for c in range(m.chunks.shape[1]):
        want = mask[:, c * TP.CHUNK_WORDS * 32 : (c + 1) * TP.CHUNK_WORDS * 32].sum(1)
        assert torch.equal(m.chunks[:, c], want.to(torch.int32))


@pytest.mark.parametrize("density", [0.0, 0.001, 0.5, 1.0])
def test_masked_collect_matches_jax(density):
    rng = np.random.default_rng(int(density * 1000) + 3)
    K, B = 4, 4096
    mask = rng.random((K, B)) < density
    mask[1, 77] = True  # every block but the empty one holds a hit
    ref_counts, ref_idx = JC.masked_collect_multi(jnp.asarray(mask), cap=B)
    counts, idx, offsets = TC.masked_collect(torch.from_numpy(mask))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert idx.dtype == torch.int32 and len(idx) == int(np.asarray(ref_counts).sum())
    ref_idx = np.asarray(ref_idx)
    for j in range(K):
        c = int(ref_counts[j])
        np.testing.assert_array_equal(idx[offsets[j] : offsets[j + 1]].numpy(), ref_idx[j, :c])
        assert (ref_idx[j, c:] == B).all()  # the JAX padding past the count


def test_compact_indices_matches_jax():
    rng = np.random.default_rng(5)
    mask = rng.random(5000) < 0.2
    ref_idx, ref_n = JC.compact_indices(jnp.asarray(mask), cap=5000)
    idx, n = TC.compact_indices(torch.from_numpy(mask))
    assert int(n) == int(ref_n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx)[: int(ref_n)])


def test_compact_bits_plain_places_only_the_given_blocks():
    rng = np.random.default_rng(9)
    K, B = 5, 9000
    mask = torch.from_numpy(rng.random((K, B)) < 0.4)
    m = TP.pack_mask_bits(mask)
    counts, all_idx, bounds = TC.masked_collect(mask)
    offsets = torch.tensor([-1, 0, -1, int(counts[1]), -1], dtype=torch.int64)
    total = int(counts[1] + counts[3])
    got = TC.compact_bits(m.bits, m.chunks, offsets, total, B)
    want = torch.cat([all_idx[bounds[1] : bounds[2]], all_idx[bounds[3] : bounds[4]]])
    assert torch.equal(got, want)


def _step_case(kind, rng, K, B):
    """Operands and extra of one collect step of `kind`, as the engine
    stacks them, with a padding row last."""
    nvs = _nvs(rng, K, B)
    if kind in ("bbox", "bbox_packed"):
        if kind == "bbox":
            xyz = [rng.integers(-3000, 3000, (K, B)).astype(np.int32) for _ in range(3)]
            los = np.full((K, 3), -1500, np.int32)
            his = np.full((K, 3), 1500, np.int32)
            los[-1], his[-1] = 0, 0
            return (*xyz, los, his, nvs), ()
        w = 12
        axes = [[_column(rng, w, B) for _ in range(K)] for _ in range(3)]
        bounds = [_residual_bounds(rng, cols, w) for cols in axes]
        los = np.stack([b[0] for b in bounds], 1)
        his = np.stack([b[1] for b in bounds], 1)
        los[-1], his[-1] = 0, -1
        return (*[_planes(c, w, B) for c in axes], los, his, nvs), ((w, w, w), B)
    if kind == "class":
        cls = rng.integers(0, 8, (K, B)).astype(np.uint8)
        return (cls, np.full(K, 3, np.int32), nvs), ()
    if kind == "class_dict":
        k = 2
        codes = rng.integers(0, 4, (K, B)).astype(np.uint8)
        cp = np.zeros((K, host.packed_row_width(k, B)), np.uint8)
        for j in range(K):
            host.pack_bits_into(cp[j], codes[j], k, 0, B)
        targets = np.array([1, 4, 0, 3, 0][:K], np.int32)  # 4: a miss
        return (cp, targets, nvs), (k, B)
    th = rng.integers(-5, 5, (K, B)).astype(np.int32)
    tl = rng.integers(I32.min, I32.max, (K, B)).astype(np.int32)
    qs = np.tile(np.array([-2, 0, 3, 0], np.int32), (K, 1))
    if kind == "time":
        return (th, tl, qs, nvs), ()
    cols_h = [(th[j], int(th[j].min())) for j in range(K)]
    cols_l = [(tl[j], 0) for j in range(K)]
    q = np.stack([host._packed_time_query(qs[j], np.array([cols_h[j][1], 0]))
                  for j in range(K)])
    return (_planes(cols_h, 4, B), _planes(cols_l, 32, B), q, nvs), ((4, 32), B)


@pytest.mark.parametrize("kind", ["bbox", "bbox_packed", "class", "class_dict", "time",
                                  "time_packed"])
def test_collect_step_matches_jax_sharded_collect(kind):
    """One collect step: per-block counts and, for the partial blocks, the
    ascending hit indices, against sharded_collect with cap = B."""
    rng = np.random.default_rng(len(kind))
    K, B = 5, 2048
    arrays, extra = _step_case(kind, rng, K, B)
    mesh = mesh_mod.make_mesh(1)
    ref_counts, ref_idx = mesh_mod.sharded_collect(mesh, kind, arrays, B, extra)
    ref_counts, ref_idx = np.asarray(ref_counts), np.asarray(ref_idx)
    mask = step.collect_mask(kind, _t(*arrays), extra)
    np.testing.assert_array_equal(mask.counts.numpy(), ref_counts)
    offsets = np.full(K, -1, np.int64)
    total = 0
    for j, c in enumerate(ref_counts):
        if 0 < c < arrays[-1][j]:
            offsets[j], total = total, total + int(c)
    assert total > 0
    idx = step.collect_indices(mask, torch.from_numpy(offsets), total, B).numpy()
    for j, c in enumerate(ref_counts):
        if offsets[j] >= 0:
            np.testing.assert_array_equal(idx[offsets[j] : offsets[j] + c], ref_idx[j, :c])

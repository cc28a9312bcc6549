"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no jax, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers: kernel and plain version must be equal (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_torch import engine, host
from adhoc_queries_pointclouds_torch.ops import compact as TC
from adhoc_queries_pointclouds_torch.ops import density as TD
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from adhoc_queries_pointclouds_torch.tools import packed_bench
from adhoc_queries_pointclouds_torch import index as index_mod
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
    TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.utils.aabb import AABB, parse_aabb

pytestmark = pytest.mark.cuda
I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raw(rng, K, B):
    xyz = [rng.integers(I32.min, I32.max, (K, B), endpoint=True).astype(np.int32)
           for _ in range(3)]
    los = rng.integers(I32.min, 0, (K, 3)).astype(np.int32)
    his = rng.integers(0, I32.max, (K, 3)).astype(np.int32)
    los[0], his[0] = I32.min, I32.max
    los[-1], his[-1] = 0, -1  # padding row
    nvs = np.array([B, 0, 1, max(B - 1, 0), B + 5, -3, B // 2][:K], np.int32)
    return (*xyz, los, his, nvs)


def _both(fn, args, dev, *extra):
    cpu = [torch.from_numpy(a) for a in args]
    gpu = [t.to(dev) for t in cpu]
    got = fn(*gpu, *extra)
    torch.cuda.synchronize()
    return got.cpu(), fn(*cpu, *extra)


@pytest.mark.parametrize("B", [1, 3, 4096, 4099, 262144 + 4])
def test_multi_kernel_matches_plain(dev, B):
    rng = np.random.default_rng(B)
    args = _raw(rng, 7, B)
    got, ref = _both(TP.bbox_count_multi_kernel, args, dev)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)


def test_multi_kernel_unaligned_rows(dev):
    """Rows that start off a 16-byte boundary take the scalar loads."""
    rng = np.random.default_rng(1)
    K, B = 3, 8192
    args = _raw(rng, K, B)
    buf = torch.empty(3, K * B + 1, dtype=torch.int32, device=dev)
    views = []
    for a, arr in enumerate(args[:3]):
        buf[a, 1:] = torch.from_numpy(arr.reshape(-1)).to(dev)
        views.append(buf[a, 1:].view(K, B))
    rest = [torch.from_numpy(a).to(dev) for a in args[3:]]
    got = TP.bbox_count_multi_kernel(*views, *rest)
    ref = TP.bbox_count_multi(*(torch.from_numpy(a) for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


def test_single_block_launch(dev):
    rng = np.random.default_rng(2)
    x, y, z, los, his, nvs = _raw(rng, 1, 100_000)
    gpu = [torch.from_numpy(a).to(dev) for a in (x[0], y[0], z[0], los[0], his[0])]
    got = TP.bbox_count(*gpu, torch.tensor(77_777, dtype=torch.int32, device=dev))
    ref = TP.bbox_count_multi(*(torch.from_numpy(a) for a in (x, y, z, los, his)),
                              torch.tensor([77_777], dtype=torch.int32))
    assert got.dim() == 0 and int(got) == int(ref[0])


def _packed(rng, K, B, widths):
    planes = [np.zeros((K, host.packed_row_width(k, B)), np.uint8) for k in widths]
    bases = np.zeros((K, 3), np.int64)
    his = np.zeros((K, 3), np.int64)
    los = np.zeros((K, 3), np.int64)
    for j in range(K):
        for a, k in enumerate(widths):
            base = 0 if k >= 29 else int(rng.integers(-2**30, 2**30))
            top = (1 << k) if k < 32 else 0
            col = (rng.integers(I32.min, I32.max, B, endpoint=True) if k == 32
                   else base + rng.integers(0, max(top, 1), B)).astype(np.int32)
            host.pack_bits_into(planes[a][j], col, k, base, B)
            lo_w, hi_w = np.percentile(col, [10, 85]).astype(np.int64)
            bases[j, a], los[j, a], his[j, a] = base, lo_w - base, hi_w - base
    i32 = lambda v: np.clip(v, I32.min, I32.max).astype(np.int32)  # noqa: E731
    los, his = i32(los), i32(his)
    los[-1], his[-1] = 0, -1
    nvs = rng.integers(1, B + 1, K).astype(np.int32)
    nvs[0] = B
    nvs[-1] = 0
    return (*planes, los, his, nvs)


@pytest.mark.parametrize("widths", [(0, 0, 0), (4, 4, 4), (12, 20, 28), (20, 20, 20),
                                    (28, 28, 28), (32, 32, 32), (32, 4, 0), (3, 17, 31)])
@pytest.mark.parametrize("B", [4096, 4104])  # B/8 odd: rows off 8-byte boundaries
def test_packed_kernel_matches_plain(dev, widths, B):
    rng = np.random.default_rng(sum(widths) + B)
    args = _packed(rng, 5, B, widths)
    got, ref = _both(TP.bbox_count_packed_kernel, args, dev, widths, B)
    assert torch.equal(got, ref)
    assert int(ref[0]) > 0


# Width triples that take every branch of the packed bbox kernels' compare
# (csrc/bbox_planes.cuh): no planes, bit planes only, byte planes only, 1 to
# 3 byte planes with bit planes on top, the widest unsigned width, and raw
# signed words.
EDGE_WIDTHS = [(0, 0, 0), (1, 1, 1), (4, 4, 4), (7, 7, 7), (8, 8, 8), (9, 17, 25), (12, 20, 28),
               (20, 20, 20), (28, 28, 28), (31, 31, 31), (32, 32, 32)]


def packed_bbox_edge_case(widths, B, seed=0):
    """numpy operands (xp, yp, zp, los, his, nvs) of a packed bbox step of 24
    rows whose bounds lie at and beyond both ends of each axis's residual
    space [bot, top] = [0, 2^w - 1] ([INT32_MIN, INT32_MAX] at w = 32), as
    the engine's saturating clip of a far box makes them, over residuals of
    which about half sit at bot, bot + 1, mid - 1, mid, top - 1 and top.
    Rows 0-11 put every axis on an edge range (rotated between axes), rows
    12-23 one axis, the others taking every residual. Also used by the CPU
    tests that hold the plain versions to the JAX package."""
    rng = np.random.default_rng(seed + 1000 * sum(widths) + B)
    K = 24

    def clip(v):
        return min(max(v, int(I32.min)), int(I32.max))

    planes, ranges = [], []
    for w in widths:
        top, bot = ((1 << w) - 1, 0) if w < 32 else (int(I32.max), int(I32.min))
        mid = (top + bot) // 2
        palette = np.array([bot, min(bot + 1, top), max(mid - 1, bot), mid, max(top - 1, bot),
                            top], np.int64)
        anywhere = rng.integers(bot, top, (K, B), endpoint=True)
        r = np.where(rng.random((K, B)) < 0.5, palette[rng.integers(0, 6, (K, B))], anywhere)
        out = np.zeros((K, host.packed_row_width(w, B)), np.uint8)
        for j in range(K):
            host.pack_bits_into(out[j], r[j].astype(np.int32), w, 0, B)
        planes.append(out)
        ranges.append([
            (int(I32.min), int(I32.max)), (bot, top), (clip(bot - 1), clip(top + 1)), (top, top),
            (bot, bot), (clip(top + 1), int(I32.max)), (int(I32.min), clip(bot - 1)),
            (mid, mid - 1), (clip(bot + 1), clip(top - 1)), (int(I32.max), int(I32.max)),
            (int(I32.min), int(I32.min)), (-5, mid),
        ])
    everything = (int(I32.min), int(I32.max))
    rows = [[ranges[a][(k + a) % 12] for a in range(3)] for k in range(12)]
    rows += [[ranges[a][k] if a == k % 3 else everything for a in range(3)] for k in range(12)]
    los = np.array([[r[0] for r in row] for row in rows], np.int32)
    his = np.array([[r[1] for r in row] for row in rows], np.int32)
    nvs = np.resize(np.array([B, B - 5, 1, B - 33, B - 1, 777], np.int32), K)
    return (*planes, los, his, nvs)


def _edge_block_sizes(widths):
    """B % 128 == 0 (wide loads), B % 8 == 0 only, and, for byte planes
    only, B % 8 == 3."""
    return [4096, 4104] + ([4099] if all(w % 8 == 0 for w in widths) else [])


@pytest.mark.parametrize("widths", EDGE_WIDTHS)
def test_packed_bbox_kernels_at_the_ends_of_residual_space(dev, widths):
    for B in _edge_block_sizes(widths):
        args = packed_bbox_edge_case(widths, B)
        got, ref = _both(TP.bbox_count_packed_kernel, args, dev, widths, B)
        assert torch.equal(got, ref), (B, got, ref)
        assert int(ref.sum()) > 0
        _, mask = _mask_both(TP.bbox_mask_bits_packed, args, dev, widths, B)
        assert torch.equal(mask.counts, ref)


@pytest.mark.parametrize("k", [8, 16, 24, 32])
def test_packed_kernel_byte_planes_only(dev, k):
    rng = np.random.default_rng(k)
    B = 4099
    args = _packed(rng, 3, B, (k, k, k))
    got, ref = _both(TP.bbox_count_packed_kernel, args, dev, (k, k, k), B)
    assert torch.equal(got, ref)


def test_wrappers_reject_bad_operands(dev):
    x = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    b = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    nv = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        TP.bbox_count_multi_kernel(x.to(torch.int64), x, x, b, b, nv)
    with pytest.raises(ValueError):
        TP.bbox_count_multi_kernel(x, x.t().contiguous().t(), x, b, b, nv)
    with pytest.raises(ValueError):
        TP.bbox_count_multi_kernel(x, x, x.cpu(), b, b, nv)
    p = torch.zeros((2, 8), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        TP.bbox_count_packed_kernel(p, p, p, b, b, nv, (8, 8, 8), 16)  # rows need 16 bytes


@pytest.mark.parametrize("pack", ["1", "0"])
def test_run_query_on_cuda_matches_cpu(dev, tmp_path, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    synth.write_dataset(tmp_path, n_files=2, points_per_file=150_000, seed=4,
                        formats=("last",), clustered=True)
    plan = QueryPlan(bounds=BoundsQuery(parse_aabb("100100;200250;0;102000;200876;80")))
    kernel = "bbox_count_packed" if pack == "1" else "bbox_count_multi"
    for use_index in (False, True, True):  # the second indexed run reads the sidecar
        TP.reset_launches()
        got = engine.run_query(tmp_path / "last", plan, device=dev, block_size=1 << 15,
                               use_index=use_index)
        assert TP.launches[kernel] > 0
        ref = engine.run_query(tmp_path / "last", plan, device="cpu", block_size=1 << 15,
                               use_index=False)
        assert got.match_count == ref.match_count > 0


# ---------------------------------------------------------------- class counts

CLASS_TARGETS = [0, 6, 255, 6, 77, 3, 200]


def _class_case(rng, K, B):
    """(K, B) u8 classes, about a third of each row equal to its target, and
    n_valid ending at every alignment mod 16 near B, plus 0 and 1."""
    targets = np.array(CLASS_TARGETS[:K], np.int32)
    cls = rng.integers(0, 256, (K, B)).astype(np.uint8)
    for j in range(K):
        cls[j, rng.random(B) < 0.35] = targets[j]
    nvs = np.array([B, max(B - 1, 0), max(B - 2, 0), max(B - 3, 0), 0, 1, max(B - 13, 0)][:K],
                   np.int32)
    return cls, targets, nvs


@pytest.mark.parametrize("B", [1, 4, 4096, 4100, 4099, 262144 + 4])
def test_class_kernels_match_plain(dev, B):
    rng = np.random.default_rng(B + 7)
    args = _class_case(rng, 7, B)
    got, ref = _both(TP.class_count_multi_kernel, args, dev)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    if B % 4 == 0:
        words = (args[0].view(np.int32), *args[1:])
        got_w, ref_w = _both(TP.class_count_words_kernel, words, dev)
        assert torch.equal(got_w, ref_w) and torch.equal(got_w, ref)


def test_class_kernels_unaligned_rows_and_targets(dev):
    """Rows off 16-byte boundaries take byte loads; a target outside 0..255
    matches nothing in the u8 entry and is replicated as uint32(t) * 0x01010101
    in the word entry, as in the plain versions."""
    rng = np.random.default_rng(3)
    K, B = 4, 8192
    cls, targets, nvs = _class_case(rng, K, B)
    buf = torch.empty(K * B + 4, dtype=torch.uint8, device=dev)
    buf[4:] = torch.from_numpy(cls.reshape(-1)).to(dev)
    view = buf[4:].view(K, B)  # 4-byte but not 16-byte aligned rows
    tg, nv = (torch.from_numpy(a).to(dev) for a in (targets, nvs))
    got = TP.class_count_multi_kernel(view, tg, nv)
    ref = TP.class_count_multi(*(torch.from_numpy(a) for a in (cls, targets, nvs)))
    assert torch.equal(got.cpu(), ref)
    got_w = TP.class_count_words_kernel(view.view(torch.int32), tg, nv)
    assert torch.equal(got_w.cpu(), ref)
    odd = np.array([256, -1, 0x01020304, -256], np.int32)
    words = cls.view(np.int32)
    got, ref = _both(TP.class_count_words_kernel, (words, odd, nvs), dev)
    assert torch.equal(got, ref)
    got, ref = _both(TP.class_count_multi_kernel, (cls, odd, nvs), dev)
    assert torch.equal(got, ref) and int(ref.abs().sum()) == 0


def test_class_single_block_launches(dev):
    rng = np.random.default_rng(4)
    cls, targets, _ = _class_case(rng, 1, 65536)
    tg = torch.tensor(int(targets[0]), dtype=torch.int32, device=dev)
    nv = torch.tensor(65533, dtype=torch.int32, device=dev)
    want = int(np.count_nonzero(cls[0, :65533] == targets[0]))
    c = torch.from_numpy(cls[0]).to(dev)
    assert int(TP.class_count(c, tg, nv)) == want
    assert int(TP.class_count_packed(c.view(torch.int32), tg, nv)) == want


def _dict_case(rng, K, B, k):
    codes = rng.integers(0, 1 << k, (K, B)).astype(np.uint8)
    cp = np.zeros((K, host.packed_row_width(k, B)), np.uint8)
    for j in range(K):
        host.pack_bits_into(cp[j], codes[j], k, 0, B)
    targets = rng.integers(0, 1 << k, K).astype(np.int32)
    targets[-1] = 1 << k  # a miss: len(dict), a code no point carries
    nvs = np.array([B, max(B - 3, 0), 5, 0, B][:K], np.int32)
    return cp, targets, nvs


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [4096, 4104])  # B/8 odd: rows off 8-byte boundaries
def test_class_dict_kernel_matches_plain(dev, k, B):
    rng = np.random.default_rng(10 * k + B)
    args = _dict_case(rng, 5, B, k)
    got, ref = _both(TP.class_count_dict_kernel, args, dev, k, B)
    assert torch.equal(got, ref) and int(ref[0]) > 0 and int(ref[-1]) == 0


def test_class_dict_kernel_byte_planes_only(dev):
    rng = np.random.default_rng(11)
    B = 4099
    args = _dict_case(rng, 5, B, 8)
    got, ref = _both(TP.class_count_dict_kernel, args, dev, 8, B)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------- time counts


def _times(rng, K, B):
    """(K, B) f64 GPS times: a narrow flight-line run per row, plus edge
    values (signed zeros, infinities, NaN, subnormals) in the last row."""
    t = np.stack([rng.uniform(1e5, 1e5 + 10.0, B) for _ in range(K)])
    edges = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324, -1e300, 1e300])
    t[-1, : len(edges)] = edges[: B]
    return t


def _time_raw_case(rng, K, B):
    t = _times(rng, K, B)
    th, tl = host.encode_f64_sortable(t.reshape(-1))
    th, tl = th.reshape(K, B), tl.reshape(K, B)
    ranges = [(1e5 + 2.0, 1e5 + 7.5), (-np.inf, np.inf), (0.0, 1e5 + 5.0), (1e5 + 3.0, 1e5 + 3.0),
              (-1.0, 1e-300)]
    qs = np.array([host.encode_f64_scalar(a) + host.encode_f64_scalar(b)
                   for a, b in (ranges * 2)[:K]], np.int32)
    a, b = min(100, B - 1), min(900, B - 1)
    qs[0] = [th[0, a], tl[0, a], th[0, a], tl[0, b]]  # equal hi words
    nvs = np.array([B, max(B - 1, 0), max(B - 2, 0), 7, 0, B][:K], np.int32)
    nvs[-1] = B
    return th, tl, qs, nvs


@pytest.mark.parametrize("B", [1, 4096, 4099, 262144 + 4])
def test_time_kernel_matches_plain(dev, B):
    rng = np.random.default_rng(B + 3)
    args = _time_raw_case(rng, 6, B)
    got, ref = _both(TP.time_count_multi_kernel, args, dev)
    assert torch.equal(got, ref)


def test_time_kernel_sign_boundary(dev):
    """Encoded words around INT32_MIN/MAX compare as signed int32."""
    B = 64
    I = I32
    vals = np.array([I.min, I.min + 1, -1, 0, 1, I.max - 1, I.max, 12345], np.int32)
    th = np.tile(vals, (4, B // 8)).astype(np.int32)
    tl = np.tile(vals[::-1].copy(), (4, B // 8)).astype(np.int32)
    qs = np.array([[I.min, I.min, I.max, I.max], [-1, 0, 1, 0], [0, I.min, 0, I.max],
                   [I.max, 0, I.min, 0]], np.int32)
    nvs = np.array([B, B - 3, 61, B], np.int32)
    got, ref = _both(TP.time_count_multi_kernel, (th, tl, qs, nvs), dev)
    assert torch.equal(got, ref) and int(ref[0]) > 0


def _time_edges(k):
    """Residual-space int32 words at the ends of a k-bit column's residual
    space and beyond: int32 min and max, -1, 0, 2^k - 1 and 2^k."""
    top = (1 << k) - 1 if k < 32 else I32.max
    return sorted({I32.min, I32.max, -1, 0, min(top, I32.max), min(top + 1, I32.max)})


def _time_packed_case(rng, K, B, widths):
    """Blocks of encoded times packed at the step's widths with per-block
    bases (half of the residuals at the ends and the middle of residual
    space), and residual-space queries: row 0 as the engine makes them
    (two of the block's points, through the host's clip), then in turn
    words at every edge, equal hi words with lo at each end, start == end,
    the whole int32 range, and again two points."""
    kh, kl = widths
    planes = [np.zeros((K, host.packed_row_width(k, B)), np.uint8) for k in widths]
    qs = np.zeros((K, 4), np.int32)
    for j in range(K):
        cols = []
        for k in widths:
            if k >= 32:
                r = rng.integers(I32.min, I32.max, B, endpoint=True)
                ends = np.array([I32.min, I32.min + 1, -1, 0, I32.max - 1, I32.max])
                cols.append((np.where(rng.random(B) < 0.5, ends[rng.integers(0, 6, B)], r)
                             .astype(np.int32), 0))
            else:
                base = int(rng.integers(I32.min, I32.max - (1 << k)))
                r = rng.integers(0, 1 << k, B)
                ends = np.array([0, min(1, (1 << k) - 1), max((1 << k) - 2, 0), (1 << k) - 1])
                r = np.where(rng.random(B) < 0.5, ends[rng.integers(0, 4, B)], r)
                cols.append(((base + r).astype(np.int32), base))
        (th, bh), (tl, bl) = cols
        host.pack_bits_into(planes[0][j], th, kh, bh, B)
        host.pack_bits_into(planes[1][j], tl, kl, bl, B)
        a, b = sorted(rng.choice(B, 2, replace=False))
        q_enc = np.array([th[a], tl[a], th[b], tl[b]], np.int64)
        qs[j] = host._packed_time_query(q_enc, np.array([bh, bl], np.int64))
        h = int(th[a]) - bh  # a residual hi word some point carries
        kind = j % 6
        if kind == 1:
            qs[j] = [rng.choice(_time_edges(kh)), rng.choice(_time_edges(kl)),
                     rng.choice(_time_edges(kh)), rng.choice(_time_edges(kl))]
        elif kind == 2:
            qs[j] = [h, rng.choice([I32.min, 0]), h, rng.choice(_time_edges(kl)[-3:])]
        elif kind == 3:
            qs[j, 2:] = qs[j, :2]
        elif kind == 4:
            qs[j] = [I32.min, I32.min, I32.max, I32.max]
    nvs = rng.integers(1, B + 1, K).astype(np.int32)
    nvs[0] = B
    nvs[-1] = 0
    return (*planes, qs, nvs)


TIME_PACKED_WIDTHS = [(0, 0), (4, 12), (20, 28), (28, 28), (32, 32), (32, 4), (0, 32), (12, 20),
                      (20, 20), (4, 28), (1, 1), (7, 7), (31, 31), (3, 17), (20, 32)]


@pytest.mark.parametrize("widths", TIME_PACKED_WIDTHS)
@pytest.mark.parametrize("B", [4096, 8192, 4104])  # wide loads, and B % 128 != 0
def test_time_packed_kernel_matches_plain(dev, widths, B):
    rng = np.random.default_rng(sum(widths) * 7 + B)
    args = _time_packed_case(rng, 7, B, widths)
    got, ref = _both(TP.time_count_packed_kernel, args, dev, widths, B)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("widths", [(8, 8), (16, 16), (24, 24), (32, 32), (8, 32), (32, 16)])
def test_time_packed_kernel_byte_planes_only(dev, widths):
    rng = np.random.default_rng(sum(widths) + 1)
    B = 4099
    args = _time_packed_case(rng, 7, B, widths)
    got, ref = _both(TP.time_count_packed_kernel, args, dev, widths, B)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("widths", [(20, 32), (12, 20), (3, 17)])
@pytest.mark.parametrize("B", [1 << 19, (1 << 19) + 8])
def test_time_packed_repeated_over_mixed_blocks(dev, widths, B):
    """Sixteen blocks, more (block, tile) pairs than the persistent grid has
    CTAs: full rows, empty rows (start == end), n_valid 0, 1 and B - 1,
    random ranges in turn, so that a CTA carries one row's count and then
    the next. Fifty runs of both kernels all give the plain version's counts
    and BitMask."""
    rng = np.random.default_rng(sum(widths) + B)
    parts = [_time_packed_case(rng, 6, B, widths) for _ in range(3)]
    args = [np.concatenate([p[a] for p in parts])[:16] for a in range(4)]
    args[3][[1, 6, 11]] = [0, 1, B - 1]
    cpu = [torch.from_numpy(a) for a in args]
    gpu = [t.to(dev) for t in cpu]
    want = TP.time_count_packed_kernel(*cpu, widths, B)
    want_mask = TP.time_mask_bits_packed(*cpu, widths, B)
    assert int((want == 0).sum()) >= 2 and int((want == torch.from_numpy(args[3])).sum()) >= 2
    for _ in range(50):
        got = TP.time_count_packed_kernel(*gpu, widths, B)
        mask = TP.time_mask_bits_packed(*gpu, widths, B)
        assert torch.equal(got.cpu(), want)
        for g, r in zip(mask, want_mask):
            assert torch.equal(g.cpu(), r)
    _compact_both(dev, mask, want_mask, args[3], B)


@pytest.mark.parametrize("widths", [(20, 32), (3, 17)])
def test_packed_kernels_over_more_blocks_than_grid_y(dev, widths):
    """The four packed entries walk a one-dimensional persistent grid, so
    K is not held to a grid's 65,535 rows in y: over 65,536 blocks of 128
    points, counts and BitMask equal the plain version's."""
    B = 128
    rng = np.random.default_rng(sum(widths) + 65536)
    reps = 65536 // 7 + 1
    args = [np.tile(a, (reps, 1)) if a.ndim == 2 else np.tile(a, reps)
            for a in _time_packed_case(rng, 7, B, widths)]
    assert len(args[3]) > 65536
    got, ref = _both(TP.time_count_packed_kernel, args, dev, widths, B)
    assert torch.equal(got, ref)
    _mask_both(TP.time_mask_bits_packed, args, dev, widths, B)
    box = (*widths, 12)
    args = [np.tile(a, (reps, 1)) if a.ndim == 2 else np.tile(a, reps)
            for a in _packed(rng, 7, B, box)]
    got, ref = _both(TP.bbox_count_packed_kernel, args, dev, box, B)
    assert torch.equal(got, ref)
    _mask_both(TP.bbox_mask_bits_packed, args, dev, box, B)
    # the raw time and dictionary masks walk the same grid
    raw = [np.tile(a, (65536 // 6 + 1, 1)) if a.ndim == 2 else np.tile(a, 65536 // 6 + 1)
           for a in _time_raw_case(rng, 6, B)]
    assert len(raw[3]) > 65536
    _mask_both(TP.time_mask_bits, raw, dev)
    k = widths[1] % 8 + 1
    codes = [np.tile(a, (65536 // 5 + 1, 1)) if a.ndim == 2 else np.tile(a, 65536 // 5 + 1)
             for a in _dict_case(rng, 5, B, k)]
    assert len(codes[2]) > 65536
    _mask_both(TP.class_mask_bits_dict, codes, dev, k, B)


def test_new_wrappers_reject_bad_operands(dev):
    c = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    t = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        TP.class_count_multi_kernel(c.to(torch.int32), t, t)
    with pytest.raises(ValueError):
        TP.class_count_words_kernel(c.view(torch.int32), t[:1], t)
    with pytest.raises(ValueError):
        TP.class_count_dict_kernel(c, t, t, 16, 16)  # codes are at most 8 bits
    with pytest.raises(ValueError):
        TP.class_count_dict_kernel(c[:, :2], t, t, 1, 12)  # bit planes need B % 8 == 0
    h = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    q = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TP.time_count_multi_kernel(h, h, q[:, :3].contiguous(), t)
    with pytest.raises(ValueError):
        TP.time_count_packed_kernel(c, c, q, t, (8, 12), 16)  # 12 bits need 24 bytes


def _exact_index(data_dir):
    """Exact sidecars (class bitmaps, GPS min/max), as the index command
    writes them."""
    for f in sorted(data_dir.iterdir()):
        r = open_point_cloud(f)
        mm, bitmap, gps = index_mod.build_index(r)
        index_mod.save_index(f, mm, bitmap, gps, n_points=r.point_count)
        r.close()


@pytest.mark.parametrize("pack", ["1", "0"])
def test_class_and_time_run_query_on_cuda_matches_cpu(dev, tmp_path, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    synth.write_dataset(tmp_path, n_files=2, points_per_file=150_000, seed=4,
                        formats=("last",), clustered=True, point_format=3)
    data = tmp_path / "last"
    cases = [
        (QueryPlan(classification=ClassQuery(6)),
         "class_count_dict" if pack == "1" else "class_count_words", 1 << 15),
        (QueryPlan(classification=ClassQuery(6)),
         "class_count_dict" if pack == "1" else "class_count_multi", (1 << 15) - 2),
        (QueryPlan(time_range=TimeRangeQuery(0.4, 1.1)),
         "time_count_packed" if pack == "1" else "time_count_multi", 1 << 15),
    ]
    for use_index in (False, True):
        if use_index:
            _exact_index(data)
        for plan, kernel, block in cases:
            TP.reset_launches()
            got = engine.run_query(data, plan, device=dev, block_size=block, use_index=use_index)
            assert TP.launches[kernel] > 0
            ref = engine.run_query(data, plan, device="cpu", block_size=block, use_index=False)
            assert got.match_count == ref.match_count > 0


# ---------------------------------------------------------------- collect


def _off_bounds(t, dev):
    """The 2-D operand t on the card, one element past a 16-byte boundary:
    rows that take no wide loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1).to(dev)
    return flat[1:].view(t.shape)


def _mask_both(fn, args, dev, *extra, unaligned=False):
    """BitMask of the kernel on the card and of the plain version on the
    CPU, field by field equal; returns the plain one. unaligned: the 2-D
    operands lie one element past a 16-byte boundary on the card."""
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = fn(*(_off_bounds(t, dev) if unaligned and t.dim() == 2 else t.to(dev) for t in cpu),
             *extra)
    torch.cuda.synchronize()
    ref = fn(*cpu, *extra)
    for name, g, r in zip(ref._fields, got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r), name
    return got, ref


def _compact_both(dev, got, ref, nvs, block_size):
    """Offsets for the partial blocks only, compaction on the card against
    its plain version and against masked_collect of the unpacked mask."""
    counts = ref.counts.numpy()
    nv = np.clip(nvs, 0, block_size)
    offsets = np.full(len(counts), -1, np.int64)
    total = 0
    for j, c in enumerate(counts):
        if 0 < c < nv[j]:
            offsets[j], total = total, total + int(c)
    off = torch.from_numpy(offsets)
    idx = TC.compact_bits(got.bits, got.chunks, off.to(dev), total, block_size)
    torch.cuda.synchronize()
    want = TC.compact_bits(ref.bits, ref.chunks, off, total, block_size)
    assert torch.equal(idx.cpu(), want)
    _, all_idx, bounds = TC.masked_collect(TP.unpack_mask_bits(ref.bits, block_size))
    for j, o in enumerate(offsets):
        if o >= 0:
            assert torch.equal(want[o : o + counts[j]], all_idx[bounds[j] : bounds[j + 1]])
    return total


@pytest.mark.parametrize("B", [1, 31, 4096, 4099, 8192 * 3 + 40, 262144 + 4])
def test_mask_bits_raw_kinds_match_plain(dev, B):
    rng = np.random.default_rng(B + 101)
    x, y, z, los, his, nvs = _raw(rng, 7, B)
    # one block at about half density, one sparse
    los[1], his[1] = (I32.min, I32.min, I32.min), (0, I32.max, I32.max)
    los[2], his[2] = (I32.min, I32.min, I32.min), (I32.min + 2**22, I32.max, I32.max)
    nvs[1] = nvs[2] = B
    got, ref = _mask_both(TP.bbox_mask_bits, (x, y, z, los, his, nvs), dev)
    _compact_both(dev, got, ref, nvs, B)
    cls, targets, cnv = _class_case(rng, 7, B)
    got, ref = _mask_both(TP.class_mask_bits, (cls, targets, cnv), dev)
    _compact_both(dev, got, ref, cnv, B)
    th, tl, qs, tnv = _time_raw_case(rng, 6, B)
    got, ref = _mask_both(TP.time_mask_bits, (th, tl, qs, tnv), dev)
    _compact_both(dev, got, ref, tnv, B)
    # rows off 16-byte boundaries: the raw time mask's scalar loads at any B
    got, ref = _mask_both(TP.time_mask_bits, (th, tl, qs, tnv), dev, unaligned=True)
    _compact_both(dev, got, ref, tnv, B)


@pytest.mark.parametrize("widths", [(0, 0, 0), (4, 4, 4), (12, 20, 28), (32, 32, 32),
                                    (3, 17, 31), (20, 20, 20), (0, 4, 28), (1, 1, 1), (7, 7, 7),
                                    (31, 31, 31), (5, 3, 17)])
@pytest.mark.parametrize("B", [4096, 8192, 4104, 8192 * 2 + 264])
def test_mask_bits_packed_kinds_match_plain(dev, widths, B):
    rng = np.random.default_rng(sum(widths) + B + 7)
    args = _packed(rng, 5, B, widths)
    got, ref = _mask_both(TP.bbox_mask_bits_packed, args, dev, widths, B)
    assert int(ref.counts[0]) > 0
    _compact_both(dev, got, ref, args[-1], B)
    tw = widths[1:]
    targs = _time_packed_case(rng, 5, B, tw)
    got, ref = _mask_both(TP.time_mask_bits_packed, targs, dev, tw, B)
    _compact_both(dev, got, ref, targs[-1], B)
    for k in (0, 1, 2, 4, 8):  # k = 0: no planes, every code 0
        dargs = _dict_case(rng, 5, B, k)
        got, ref = _mask_both(TP.class_mask_bits_dict, dargs, dev, k, B)
        _compact_both(dev, got, ref, dargs[-1], B)
        _mask_both(TP.class_mask_bits_dict, dargs, dev, k, B, unaligned=True)


@pytest.mark.parametrize("k", [8, 16, 32])
def test_mask_bits_byte_planes_only(dev, k):
    """B % 8 != 0: byte planes only, rows off 8-byte boundaries."""
    rng = np.random.default_rng(k + 5)
    B = 4099
    args = _packed(rng, 3, B, (k, k, k))
    got, ref = _mask_both(TP.bbox_mask_bits_packed, args, dev, (k, k, k), B)
    _compact_both(dev, got, ref, args[-1], B)
    targs = _time_packed_case(rng, 3, B, (k, k))
    _mask_both(TP.time_mask_bits_packed, targs, dev, (k, k), B)
    dargs = _dict_case(rng, 5, B, 8)
    _mask_both(TP.class_mask_bits_dict, dargs, dev, 8, B)
    _mask_both(TP.class_mask_bits_dict, dargs, dev, 8, B, unaligned=True)


def test_mask_bits_full_and_empty_blocks(dev):
    """Full blocks and blocks with no hits: the compaction skips both."""
    B = 10_000
    x = np.arange(3 * B, dtype=np.int32).reshape(3, B)
    los = np.array([[0, 0, 0], [5, 5, 5], [0, 0, 0]], np.int32)
    his = np.array([[I32.max] * 3, [4, 4, 4], [I32.max] * 3], np.int32)
    nvs = np.array([B, B, 77], np.int32)
    got, ref = _mask_both(TP.bbox_mask_bits, (x, x, x, los, his, nvs), dev)
    assert ref.counts.tolist() == [B, 0, 77]
    assert _compact_both(dev, got, ref, nvs, B) == 0


def test_class_mask_and_compaction_over_more_blocks_than_grid_y(dev):
    """The raw class mask walks the persistent tile grid and the compaction
    a grid flattened into x, so neither holds K to a grid's 65,535 rows in
    y: over 65,548 blocks of 96 points (the byte loads) and of 128 points
    (the 16-byte loads), the BitMask and the compacted rows equal the plain
    versions'."""
    rng = np.random.default_rng(65548)
    for B in (96 + 3, 128):
        cls, targets, nvs = _class_case(rng, 7, B)
        reps = 65548 // 7 + 1
        args = (np.tile(cls, (reps, 1))[:65548], np.tile(targets, reps)[:65548],
                np.tile(nvs, reps)[:65548])
        got, ref = _mask_both(TP.class_mask_bits, args, dev)
        assert int(ref.counts.sum()) > 0
        assert _compact_both(dev, got, ref, args[2], B) > 0


def _tiled(case, rows: int):
    """The K-row operands of case repeated down to `rows` rows (1-D ones
    along their only axis)."""
    reps = rows // len(case[-1]) + 1
    return [np.tile(a, (reps, 1))[:rows] if a.ndim == 2 else np.tile(a, reps)[:rows]
            for a in case]


@pytest.mark.parametrize("entry", ["bbox_count_multi", "time_count_multi", "mask_bbox",
                                   "class_count_multi", "class_count_words", "class_count_dict"])
def test_raw_entries_over_more_blocks_than_grid_y(dev, entry):
    """No count or mask entry holds K to a grid's 65,535 rows in y: the raw
    bbox and time counts and the raw bbox mask flatten their CTA rows into
    x, and the three class counts walk the persistent tile grid. Over
    65,548 blocks of 128 points and of 99 (rows off 16-byte boundaries,
    where the entry takes them), counts and BitMask equal the plain
    versions'."""
    rows = 65548
    rng = np.random.default_rng(rows + len(entry))
    # the second size: B % 16 != 0 (B % 8 == 0 for bit planes, B % 4 == 0 for words)
    narrow = {"class_count_dict": 104, "class_count_words": 100}.get(entry, 99)
    for B in (128, narrow):
        if entry in ("bbox_count_multi", "mask_bbox"):
            args = _tiled(_raw(rng, 7, B), rows)
        elif entry == "time_count_multi":
            args = _tiled(_time_raw_case(rng, 6, B), rows)
        elif entry == "class_count_dict":
            args = _tiled(_dict_case(rng, 5, B, 2), rows)
        else:
            args = _tiled(_class_case(rng, 7, B), rows)
        assert len(args[-1]) == rows
        if entry == "mask_bbox":
            got, ref = _mask_both(TP.bbox_mask_bits, args, dev)
            assert int(ref.counts.sum()) > 0
            continue
        extra = ()
        if entry == "class_count_words":
            args[0] = args[0].view(np.int32)
        elif entry == "class_count_dict":
            extra = (2, B)
        fn = {"bbox_count_multi": TP.bbox_count_multi_kernel,
              "time_count_multi": TP.time_count_multi_kernel,
              "class_count_multi": TP.class_count_multi_kernel,
              "class_count_words": TP.class_count_words_kernel,
              "class_count_dict": TP.class_count_dict_kernel}[entry]
        got, ref = _both(fn, args, dev, *extra)
        assert torch.equal(got, ref) and int(ref.sum()) > 0


def _workspace_clear(dev):
    """Every class count's workspace on the card is back to all 0."""
    for (index, _), work in TP._workspaces.items():
        if index == dev.index:
            assert int(work.abs().sum()) == 0


@pytest.mark.parametrize("K, B", [(3, 1 << 21), (200, 1 << 17), (1, 2200 * 8192 + 40), (5, 96)],
                         ids=["tiles_below_grid", "rows_across_ctas", "row_over_grid",
                              "one_cta_a_row"])
def test_class_counts_write_their_output(dev, K, B):
    """The class counts write out[k] through a per-row ticket word (no fill
    of out): where a row's tiles are fewer than the grid (each CTA one
    tile), where a CTA walks tiles of several rows, where one row has more
    tiles (of up to 4 chunks) than the grid has CTAs, and where one CTA
    covers a row. Ten calls in a row into outputs that hold garbage equal
    the plain versions, and each leaves the workspace all 0."""
    rng = np.random.default_rng(K + B)
    cls, targets, nvs = _tiled(_class_case(rng, min(K, 7), B), K)
    nvs[0] = B
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in (cls, targets, nvs)]
    want = TP.class_count_multi(*cpu)
    gpu = [t.to(dev) for t in cpu]
    k = 4
    dict_ops = _tiled(_dict_case(rng, max(2, min(K, 5)), B, k), K) if B % 8 == 0 else None
    for _ in range(10):
        torch.empty(4 * K + 64, dtype=torch.int32, device=dev).fill_(-7)  # garbage to reuse
        assert torch.equal(TP.class_count_multi_kernel(*gpu).cpu(), want)
        if B % 4 == 0:
            words = gpu[0].view(torch.int32)
            assert torch.equal(TP.class_count_words_kernel(words, *gpu[1:]).cpu(), want)
        if dict_ops is not None:
            got, ref = _both(TP.class_count_dict_kernel, dict_ops, dev, k, B)
            assert torch.equal(got, ref)
        torch.cuda.synchronize()
        _workspace_clear(dev)
    assert int(want.sum()) > 0


def test_class_counts_on_two_streams(dev):
    """Each stream has its own workspace: counts launched on two streams at
    once, many times, equal the plain version's."""
    rng = np.random.default_rng(77)
    cls, targets, nvs = _tiled(_class_case(rng, 7, 1 << 16), 64)
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in (cls, targets, nvs)]
    want = TP.class_count_multi(*cpu)
    gpu = [t.to(dev) for t in cpu]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    for _ in range(20):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                outs.append(TP.class_count_multi_kernel(*gpu))
    torch.cuda.synchronize()
    assert all(torch.equal(o.cpu(), want) for o in outs)
    _workspace_clear(dev)


CLASS_EDGE_TARGETS = [-1, 0, 255, 256, I32.max, I32.min, 6]


@pytest.mark.parametrize("B", [4096, 4096 + 16, 4099, 8192 * 2 + 264])
def test_class_mask_edge_targets(dev, B):
    """Targets at and beyond both ends of a byte over bytes that are mostly
    0, 6 and 255: outside 0..255 nothing matches. On 16-byte loads (B % 16
    == 0 and aligned rows), on rows one byte off 16-byte boundaries and at
    B % 16 != 0 (byte loads), with n_valid 0, 1, B - 1 and B."""
    rng = np.random.default_rng(B + 13)
    pal = np.array([0, 6, 255], np.uint8)
    rows = [(t, nv) for t in CLASS_EDGE_TARGETS for nv in (0, 1, B - 1, B)]
    cls = np.where(rng.random((len(rows), B)) < 0.6, pal[rng.integers(0, 3, (len(rows), B))],
                   rng.integers(0, 256, (len(rows), B))).astype(np.uint8)
    args = (cls, np.array([t for t, _ in rows], np.int32), np.array([n for _, n in rows], np.int32))
    for unaligned in (False, True):
        got, ref = _mask_both(TP.class_mask_bits, args, dev, unaligned=unaligned)
        _compact_both(dev, got, ref, args[2], B)
    counts = ref.counts.numpy().reshape(len(CLASS_EDGE_TARGETS), 4)
    assert counts[[0, 3, 4, 5]].sum() == 0 and counts[[1, 2, 6], 3].min() > 0


def test_compaction_edge_blocks(dev):
    """A block whose hits lie only in its last, partial word, a block with
    one hit, and a block with all rows but one hit, beside a full block
    and an empty one (both skipped): the compaction on the card equals its
    plain version and torch.nonzero."""
    B = 3 * 8192 + 45
    hit = np.zeros((5, B), bool)
    hit[0, B - 13:] = True  # the last word holds 13 rows
    hit[1, 2 * 8192 + 7] = True
    hit[2] = True
    hit[2, 5] = False
    hit[3] = True
    ref = TP.pack_mask_bits(torch.from_numpy(hit))
    got = TP.BitMask(*(t.to(dev) for t in ref))
    nvs = np.full(5, B, np.int32)
    assert _compact_both(dev, got, ref, nvs, B) == 13 + 1 + B - 1
    off = torch.tensor([0, 13, 14, -1, -1], dtype=torch.int64, device=dev)
    idx = TC.compact_bits(got.bits, got.chunks, off, 13 + 1 + B - 1, B)
    assert torch.equal(idx.cpu(), torch.nonzero(torch.from_numpy(hit[:3]))[:, 1].to(torch.int32))


def test_mask_wrappers_reject_bad_operands(dev):
    x = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    b = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    nv = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        TP.bbox_mask_bits(x.to(torch.int64), x, x, b, b, nv)
    with pytest.raises(ValueError):
        TP.class_mask_bits(x.to(torch.uint8), nv[:1], nv)
    m = TP.bbox_mask_bits(x, x, x, b, b, nv)
    with pytest.raises(ValueError):
        TC.compact_bits(m.bits, m.chunks, nv.to(torch.int64)[:1], 0, 16)
    with pytest.raises(TypeError):
        TC.compact_bits(m.bits, m.chunks, nv, 0, 16)


@pytest.mark.parametrize("n", [0, 1, 4099, 262144, 1 << 20])
def test_bbox_probe_kernels_match_plain(dev, n):
    rng = np.random.default_rng(n + 3)
    x, y, z = (rng.integers(-(2**30), 2**30, n).astype(np.int32) for _ in range(3))
    lo = np.full(3, -(2**29), np.int32)
    hi = np.full(3, 2**29, np.int32)
    cpu = [torch.from_numpy(a) for a in (x, y, z, lo, hi)]
    gpu = [t.to(dev) for t in cpu]
    for nv in {0, n // 3, n, n + 9}:
        nvt = torch.tensor(nv, dtype=torch.int32)
        got = TP.bbox_probe_acc_kernel(*gpu, nvt.to(dev))
        assert got.dim() == 0 and int(got) == int(TP.bbox_probe_acc(*cpu, nvt))
    got = TP.bbox_probe_acc_nomask_kernel(*gpu)
    assert int(got) == int(TP.bbox_probe_acc_nomask(*cpu))
    if n > 1:  # columns off 16-byte boundaries take the scalar loads
        un = [t[1:] for t in gpu[:3]]
        got = TP.bbox_probe_acc_nomask_kernel(*un, *gpu[3:])
        assert int(got) == int(TP.bbox_probe_acc_nomask(*(t[1:] for t in cpu[:3]), *cpu[3:]))


@pytest.mark.parametrize("pack", ["1", "0"])
def test_collect_on_cuda_matches_cpu(dev, tmp_path, monkeypatch, pack):
    """-o LAS files byte-identical and keep_hits equal between the card and
    the CPU path, for every predicate, index off and exact."""
    import filecmp

    monkeypatch.setenv("AQPC_PACK", pack)
    synth.write_dataset(tmp_path / "d", n_files=2, points_per_file=150_000, seed=4,
                        formats=("last",), clustered=True, point_format=3)
    data = tmp_path / "d" / "last"
    cases = [
        (dict(bounds=BoundsQuery(parse_aabb("100100;200250;0;102000;200876;80"))),
         "mask_bbox_packed" if pack == "1" else "mask_bbox", 1 << 15),
        (dict(classification=ClassQuery(6)),
         "mask_class_dict" if pack == "1" else "mask_class", (1 << 15) - 2),
        (dict(time_range=TimeRangeQuery(0.4, 1.1)),
         "mask_time_packed" if pack == "1" else "mask_time", 1 << 15),
    ]
    for use_index in (False, True):
        if use_index:
            _exact_index(data)
        for n, (query, kernel, block) in enumerate(cases):
            outs = []
            for device in (dev, "cpu"):
                out = tmp_path / f"out_{use_index}_{n}_{device}"
                out.mkdir()
                TP.reset_launches()
                res = engine.run_query(data, QueryPlan(output_dir=out, **query), device=device,
                                       block_size=block, use_index=use_index, keep_hits=True)
                outs.append((res, TP.launches[kernel], TP.launches["compact_bits"]))
            (got, mask_n, compact_n), (ref, cpu_n, _) = outs
            assert mask_n > 0 and compact_n > 0 and cpu_n == 0
            assert got.match_count == ref.match_count > 0
            assert len(got.output_files) == len(ref.output_files) == 2
            for a, b in zip(got.output_files, ref.output_files):
                assert filecmp.cmp(a, b, shallow=False)
            for a, b in zip(got.hits, ref.hits):
                np.testing.assert_array_equal(a.position_world, b.position_world)
                np.testing.assert_array_equal(a.classification, b.classification)


# ------------------------------------------------------------------ density


def _density_step(rng, K, B, cell, zmax=100.0):
    """K blocks over a 1000 x 1000 x zmax m grid at scale 0.001: points
    inside, beyond the max face, below the grid and at the int32 extremes."""
    grid = TD.GridSpec3D.create(AABB((0.0, 0.0, 0.0), (1000.0, 1000.0, zmax)), cell)
    tables = grid.file_tables((0.001,) * 3, (0.0,) * 3)
    xyz = [rng.integers(0, top, (K, B)).astype(np.int32) for top in (10**6, 10**6, 10**5)]
    edge = np.array([I32.min, I32.max, 10**6, 10**6 + 9, -7, 5000, 5100, 4900], np.int32)
    for a in range(3):
        xyz[a][:, : min(B, 8)] = np.roll(edge, a)[: min(B, 8)]
    rows = rng.random((K, B)) < np.array([0.0, 0.001, 0.5, 1.0])[:K, None]
    nvs = np.array([B, B, max(B - 1, 0), B, 1, 0][:K], np.int32)
    return tables, xyz, rows, nvs


def _density_both(dev, tables, xyz, rows, nvs, B, **packed):
    """The density step on the card (both passes, the table sized as the
    engine sizes it) and on the CPU over the same operands: the candidates'
    BitMasks, after the leaders table, read through table_leaders, was held
    equal to density_leaders_plain's (keys and d2 bits) for every block."""
    outs = []
    for d in (dev, torch.device("cpu")):
        t = TD.tables_to_device(tables, d)
        mask = TP.pack_mask_bits(torch.from_numpy(rows).to(d))
        kw = {k: (v.to(d) if torch.is_tensor(v) else v) for k, v in packed.items()}
        pts = tuple(torch.from_numpy(a).to(d) for a in xyz)
        nv = torch.from_numpy(nvs).to(d)
        if d.type == "cuda":
            table = TD.density_leaders(
                pts, mask.bits, nv, t, B, **kw,
                slots=TD.table_slots(int(mask.counts.max()), TD.grid_cells(t)))
            got = TD.density_candidates(pts, mask.bits, nv, t, table, B, **kw)
            leaders = TD.table_leaders(table.cpu(), len(nvs), TD.grid_cells(t))
        else:
            got = TD.density_candidates_bits(pts, mask, nv, t, B, **kw)
            if packed:
                pts = TD.unpack_xyz(pts, kw["bases"], kw["widths"], B)
            want = TD.density_leaders_plain(*pts, torch.from_numpy(rows), nv, t)
            for (gk, gv), (wk, wv) in zip(leaders, want):
                assert torch.equal(gk, wk) and torch.equal(gv, wv.view(torch.int32))
        outs.append([g.cpu() for g in got])
    torch.cuda.synchronize()
    return outs


def _planes(xyz, widths, B):
    """xyz as (K, row width) u8 plane stacks of the residuals above each
    block's least value (base 0 at 32 bits), and the (K, 3) int32 bases."""
    K = xyz[0].shape[0]
    bases, planes = np.zeros((K, 3), np.int32), []
    for a, w in enumerate(widths):
        out = np.zeros((K, host.packed_row_width(w, B)), np.uint8)
        for k in range(K):
            if w < 32:
                bases[k, a] = xyz[a][k].min()
                assert int(xyz[a][k].max()) - int(bases[k, a]) < 1 << w
            host.pack_bits_into(out[k], xyz[a][k], w, int(bases[k, a]), B)
        planes.append(out)
    return planes, torch.from_numpy(bases)


def _density_both_ways(dev, tables, xyz, rows, nvs, B, widths):
    """_density_both raw, then packed at widths; the two equal each other."""
    got, ref = _density_both(dev, tables, xyz, rows, nvs, B)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    planes, bases = _planes(xyz, widths, B)
    pgot, pref = _density_both(dev, tables, planes, rows, nvs, B, bases=bases, widths=widths)
    for g, r, w in zip(pgot, pref, ref):
        assert torch.equal(g, r) and torch.equal(g, w)
    return got


@pytest.mark.parametrize("cell", [2.0, 10.0, 100.0], ids=["sparse", "main", "contended"])
@pytest.mark.parametrize("B", [8, 4096, 8192 + 24, 8192 + 3, 262144])
def test_density_kernels_match_plain(dev, B, cell):
    rng = np.random.default_rng(B)
    tables, xyz, rows, nvs = _density_step(rng, 4, B, cell)
    before = dict(TP.launches)
    got, ref = _density_both(dev, tables, xyz, rows, nvs, B)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert TP.launches["density_leaders"] == before["density_leaders"] + 1
    assert TP.launches["density_candidates"] == before["density_candidates"] + 1
    assert int(got[1].sum()) > 0


def test_density_kernels_degenerate_axis_and_full_table(dev):
    """A zero-extent axis puts every point in its cell 0; a table with fewer
    slots than cells loses no candidate (the kernel keeps what it cannot
    look up), so the result is a superset of the plain version's."""
    rng = np.random.default_rng(5)
    B = 4096
    tables, xyz, rows, nvs = _density_step(rng, 4, B, 10.0, zmax=0.0)
    got, ref = _density_both(dev, tables, xyz, rows, nvs, B)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    tables, xyz, rows, nvs = _density_step(rng, 4, B, 100.0)  # 100 cells, 64 slots
    t = TD.tables_to_device(tables, dev)
    mask = TP.pack_mask_bits(torch.from_numpy(rows).to(dev))
    small = TD.density_candidates_bits(tuple(torch.from_numpy(a).to(dev) for a in xyz), mask,
                                       torch.from_numpy(nvs).to(dev), t, B, slots=64)
    _, ref = _density_both(dev, tables, xyz, rows, nvs, B)
    have = TP.unpack_mask_bits(small.bits.cpu(), B)
    want = TP.unpack_mask_bits(ref[0], B)
    assert bool((have | ~want).all()) and int(have.sum()) > int(want.sum())


@pytest.mark.parametrize("widths", [(0, 4, 12), (20, 20, 20), (28, 32, 8), (3, 7, 13)], ids=str)
@pytest.mark.parametrize("B", [4096, 8192 + 24])
def test_density_packed_kernels_match_plain(dev, B, widths):
    rng = np.random.default_rng(B + sum(widths))
    K = 4
    tables, xyz, rows, nvs = _density_step(rng, K, B, 10.0)
    for a, w in enumerate(widths):
        if w < 32:
            span = (1 << w)
            low = (10**6 if a < 2 else 10**5) // 2 - span // 2
            xyz[a] = (low + rng.integers(0, max(span, 1), (K, B))).astype(np.int32)
    planes, bases = _planes(xyz, widths, B)
    got, ref = _density_both(dev, tables, planes, rows, nvs, B, bases=bases, widths=widths)
    raw_ref = TP.pack_mask_bits(TD.density_candidates_plain(
        *(torch.from_numpy(a) for a in xyz), torch.from_numpy(rows), torch.from_numpy(nvs),
        TD.tables_to_device(tables, "cpu")))
    for g, r, w in zip(got, ref, raw_ref):
        assert torch.equal(g, r) and torch.equal(g, w)


def test_density_kernels_contended_grid(dev):
    """The 30 m grid: the full block puts over a hundred points in each of
    its 34 x 34 x 4 cells (the warps' equal keys meet before the atomics);
    raw and packed at 32 bits (the edge points span int32)."""
    rng = np.random.default_rng(30)
    B = 1 << 19
    tables, xyz, rows, nvs = _density_step(rng, 4, B, 30.0)
    assert TD.table_slots(B, 34 * 34 * 4) == 16384
    got = _density_both_ways(dev, tables, xyz, rows, nvs, B, (32, 32, 32))
    assert int(got[1][3]) > 0


def _sorted_step(rng, K, B, cell, span):
    """K full blocks of points in a box of span cells a side (40 x 40 x 10)
    from the origin of a 1000 x 1000 x 100 m grid at scale 0.001, each block
    sorted in cell order (z, then y, then x), as a file written in tile
    order gives them."""
    grid = TD.GridSpec3D.create(AABB((0.0, 0.0, 0.0), (1000.0, 1000.0, 100.0)), cell)
    tables = grid.file_tables((0.001,) * 3, (0.0,) * 3)
    units = round(cell / 0.001)
    xyz = [rng.integers(0, n * units, (K, B)).astype(np.int32) for n in span]
    for k in range(K):
        order = np.lexsort(tuple(a[k] // units for a in xyz))
        for a in xyz:
            a[k] = a[k][order]
    rows = np.ones((K, B), bool)
    nvs = np.array([B, B - 1, B // 2, 0][:K], np.int32)
    return tables, xyz, rows, nvs


@pytest.mark.parametrize("cell,slot_bytes", [(10.0, 8), (0.05, 16)], ids=["word", "wide"])
def test_density_kernels_sorted_step(dev, cell, slot_bytes):
    """Points in cell order, about 8 in each of 40 x 40 x 10 cells, so a
    thread's consecutive points and a warp's lanes share cells: both slot
    layouts (the 0.05 m grid has 20000 x 20000 x 2000 cells, >= 2^32)."""
    rng = np.random.default_rng(8)
    B = 1 << 17
    tables, xyz, rows, nvs = _sorted_step(rng, 4, B, cell, (40, 40, 10))
    assert TD.slot_bytes(TD.grid_cells(tables)) == slot_bytes
    widths = tuple(int(np.max([a[k].max() - a[k].min() for k in range(4)])).bit_length()
                   for a in xyz)
    _density_both_ways(dev, tables, xyz, rows, nvs, B, widths)


def test_density_kernels_grid_of_2_32_cells(dev):
    """A grid of 20000 x 20000 x 2000 cells takes 16-byte slots and hashed
    probes (far more cells than slots); points anywhere in it, with the
    edge points of _density_step."""
    rng = np.random.default_rng(32)
    B = 8192 + 24
    tables, xyz, rows, nvs = _density_step(rng, 4, B, 0.05)
    cells = TD.grid_cells(TD.tables_to_device(tables, "cpu"))
    assert cells == 20000 * 20000 * 2000 and TD.slot_bytes(cells) == 16
    _density_both_ways(dev, tables, xyz, rows, nvs, B, (32, 32, 32))


def test_density_candidates_repeated_over_mixed_blocks(dev):
    """Sixteen blocks of 2^19 + 3 points (a partial last tile in each), hit
    free, sparse, half and full blocks in turn, n_valid 0 and 1 among them:
    more (block, tile) pairs than the persistent grid has CTAs, so a CTA
    sums the counts of one tile after another, the warps of a hit-free
    tile reaching the next sum early. Fifty runs of both passes on the card
    all give the plain version's BitMask."""
    rng = np.random.default_rng(19)
    B = (1 << 19) + 3
    parts = [_density_step(rng, 4, B, 10.0) for _ in range(4)]
    tables = parts[0][0]
    xyz = [np.concatenate([p[1][a] for p in parts]) for a in range(3)]
    rows = np.concatenate([p[2] for p in parts])
    nvs = np.concatenate([p[3] for p in parts])
    nvs[4], nvs[9] = 0, 1
    got, ref = _density_both(dev, tables, xyz, rows, nvs, B)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    t = TD.tables_to_device(tables, dev)
    mask = TP.pack_mask_bits(torch.from_numpy(rows).to(dev))
    pts = tuple(torch.from_numpy(a).to(dev) for a in xyz)
    nv = torch.from_numpy(nvs).to(dev)
    slots = TD.table_slots(int(mask.counts.max()), TD.grid_cells(t))
    for _ in range(50):
        table = TD.density_leaders(pts, mask.bits, nv, t, B, slots=slots)
        again = TD.density_candidates(pts, mask.bits, nv, t, table, B)
        for g, r in zip(again, ref):
            assert torch.equal(g.cpu(), r)


def test_density_wrappers_refuse_bad_operands(dev):
    rng = np.random.default_rng(9)
    B = 4096
    tables, xyz, rows, nvs = _density_step(rng, 4, B, 10.0)
    t = TD.tables_to_device(tables, dev)
    mask = TP.pack_mask_bits(torch.from_numpy(rows).to(dev))
    pts = tuple(torch.from_numpy(a).to(dev) for a in xyz)
    nv = torch.from_numpy(nvs).to(dev)
    with pytest.raises(TypeError):
        TD.density_candidates_bits((pts[0].long(), *pts[1:]), mask, nv, t, B)
    with pytest.raises(ValueError):
        TD.density_candidates_bits(pts, mask, nv.cpu(), t, B)
    with pytest.raises(ValueError):
        TD.density_candidates_bits(pts, mask, nv, dict(t, cfx=t["cfx"][:-1]), B)
    with pytest.raises(ValueError):
        TD.density_candidates_bits(pts, mask, nv, t, B, slots=100)


@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("spec", [
    dict(bounds=BoundsQuery(parse_aabb("100200;200300;10;101500;200800;60"))),
    dict(classification=ClassQuery(6)),
    dict(time_range=TimeRangeQuery(0.1, 0.9)),
], ids=["box", "class", "time"])
@pytest.mark.parametrize("scope", ["file", "global"])
def test_density_engine_matches_cpu(dev, tmp_path, monkeypatch, scope, spec, pack):
    """run_query of a density plan on the card and on the CPU: the same
    winners, field by field."""
    monkeypatch.setenv("AQPC_PACK", pack)
    synth.write_dataset(tmp_path, n_files=2, points_per_file=150_000, seed=3, formats=("last",),
                        clustered=True, point_format=3)
    plan = QueryPlan(density=DensityConfig(6.0, scope), **spec)
    states = []
    for d in ("cuda", "cpu"):
        state = {}
        before = dict(TP.launches)
        res = engine.run_query(tmp_path / "last", plan, device=d, block_size=1 << 15,
                               density_state_out=state)
        states.append((res.match_count, state))
        suffix = "_packed" if pack == "1" else ""
        launched = TP.launches[f"density_candidates{suffix}"] - before[f"density_candidates{suffix}"]
        assert (launched > 0) == (d == "cuda")
    (n_got, got), (n_ref, ref) = states
    assert n_got == n_ref > 0
    pairs = ([(got["global"], ref["global"])] if scope == "global"
             else [(got["file"][i], ref["file"][i]) for i in sorted(ref["file"])])
    for a, b in pairs:
        assert np.array_equal(a, b)


GATHER_SHAPES = {"aligned": (7, 4096), "partial_last_word": (7, 4099),
                 "chunks": (5, 8192 * 3 + 40), "short": (6, 99), "over_grid_y": (65548, 128)}
GATHER_EDGES = {label: (rows, skip) for label, rows, skip in packed_bench.gather_edges()}


@pytest.mark.parametrize("case", [*GATHER_SHAPES, *GATHER_EDGES])
def test_compact_bits_gather_matches_plain(dev, case):
    """The compaction that gathers x, y and z against its plain version:
    blocks with no hits, a few, half, all (full blocks keep their offset
    here, as the resident density path gives them), skipped blocks, and
    every block skipped; then the edges of its dense (16-byte) and sparse
    paths (tools/packed_bench.py gather_edges: a warp at the density
    threshold and one below it, one hit a sector, full spans and chunks
    next to empty ones, outputs off 16-byte boundaries, hits in a partial
    last word at B % 4 == 0 and 1)."""
    if case in GATHER_SHAPES:
        K, B = GATHER_SHAPES[case]
        rng = np.random.default_rng(K + B)
        shares = np.resize([0.0, 0.001, 0.5, 1.0, 0.3, 0.05, 0.9], K)
        rows = rng.random((K, B)) < shares[:, None]
        skip = [j for j in range(K) if j % 3 == 2]  # every third block skipped
    else:
        rows, skip = GATHER_EDGES[case]
        K, B = rows.shape
        rng = np.random.default_rng(K + B)
    mask = TP.pack_mask_bits(torch.from_numpy(rows))
    xyz = [torch.from_numpy(rng.integers(I32.min, I32.max, (K, B), endpoint=True)
                            .astype(np.int32)) for _ in range(3)]
    counts = mask.counts.numpy()
    for skipped in (skip, range(K)):  # the case's blocks skipped; every block skipped
        offsets = np.full(K, -1, np.int64)
        total = 0
        for j in range(K):
            if j not in skipped:
                offsets[j], total = total, total + int(counts[j])
        off = torch.from_numpy(offsets)
        before = TP.launches["compact_bits_gather"]
        got = TC.compact_bits_gather(mask.bits.to(dev), mask.chunks.to(dev), off.to(dev), total,
                                     B, *(t.to(dev) for t in xyz))
        torch.cuda.synchronize()
        assert TP.launches["compact_bits_gather"] == before + 1
        want = TC.compact_bits_gather_plain(mask.bits, mask.chunks, off, total, B, *xyz)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        assert torch.equal(want[0], TC.compact_bits(mask.bits, mask.chunks, off, total, B))
        assert (total > 0) == (skipped is skip)


def test_launch_on_a_second_card_matches_plain(dev):
    """A kernel launched on cuda:1 while cuda:0 is current runs on cuda:1
    (its stream, its grid) and gives the plain version's counts."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    second = torch.device("cuda", 1)
    args = _raw(np.random.default_rng(16), 7, 1 << 16)
    TP.reset_launches()
    with torch.cuda.device(dev):
        got, want = _both(TP.bbox_count_multi_kernel, args, second)
    assert torch.equal(got, want)
    assert TP.device_launches == {("bbox_count_multi", 1): 1}


def test_two_shards_on_one_card_match_the_cpu(dev, tmp_path):
    """run_query over devices [cuda:0, cuda:0] (every step split in two
    shards, both on the card) and a resident dataset over the same two
    shards: counts, collected hits and density winners equal the one-shard
    CPU run's, and every launch is counted on card 0."""
    from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset

    synth.write_dataset(tmp_path, n_files=3, points_per_file=40_000, seed=16,
                        formats=("last",), clustered=True, point_format=3)
    data = tmp_path / "last"
    box = parse_aabb("100200;200300;10;102500;200800;60")
    plans = [QueryPlan(bounds=BoundsQuery(box)), QueryPlan(classification=ClassQuery(6)),
             QueryPlan(time_range=TimeRangeQuery(0.1, 0.6)),
             QueryPlan(bounds=BoundsQuery(box), density=DensityConfig(9.0))]
    shards = [dev, dev]
    TP.reset_launches()
    for plan in plans:
        kw = dict(block_size=1 << 13, use_index=False, keep_hits=True)
        want = engine.run_query(data, plan, device="cpu", **kw)
        got = engine.run_query(data, plan, device="cuda", devices=shards, **kw)
        assert got.match_count == want.match_count > 0
        for a, b in zip(want.hits, got.hits):
            assert np.array_equal(a.position_world, b.position_world)
    cpu = ResidentDataset.load(data, device="cpu", block_size=1 << 13,
                               attrs=("position", "classification", "gps_time"))
    card = ResidentDataset.load(data, devices=shards, block_size=1 << 13,
                                attrs=("position", "classification", "gps_time"))
    assert [s.device for s in card.shards] == shards and card.n_blocks % 2 == 0
    for plan in plans:
        assert card.count(plan) == cpu.count(plan) > 0
    assert TP.device_launches and {card for _, card in TP.device_launches} == {0}


@pytest.mark.parametrize("B", [128, 99], ids=["words", "u8_rows"])
def test_resident_count_over_more_blocks_than_grid_y(dev, tmp_path, B):
    """A resident count is one launch of its predicate's count entry over
    every block, summed in int64: over 65,548 blocks of one file, the bbox,
    class and GPS-time counts equal a numpy oracle of the same columns."""
    from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset, ResidentShard
    from adhoc_queries_pointclouds_torch.utils.aabb import clamp_bounds_to_i32, local_query_bounds

    synth.write_dataset(tmp_path, n_files=1, points_per_file=1000, seed=4, formats=("last",))
    f = sorted((tmp_path / "last").iterdir())[0]
    r = open_point_cloud(f)
    h = r.header
    r.close()
    rows = 65548
    rng = np.random.default_rng(rows + B)
    box = AABB((100200.0, 200300.0, 10.0), (100700.0, 200800.0, 60.0))
    lo, hi = clamp_bounds_to_i32(*local_query_bounds(box, h.scale, h.offset))
    xyz = [rng.integers(int(lo[a]) - 200_000, int(hi[a]) + 200_000, (rows, B)).astype(np.int32)
           for a in range(3)]
    cls = rng.integers(0, 8, (rows, B)).astype(np.uint8)
    times = rng.uniform(0.0, 100.0, (rows, B))
    th, tl = host.encode_f64_sortable(times.reshape(-1))
    nvs = rng.integers(0, B + 1, rows).astype(np.int32)
    valid = np.arange(B)[None, :] < nvs[:, None]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    shard = ResidentShard(
        device=dev, lo=0, hi=rows, nvs=put(nvs), xs=put(xyz[0]), ys=put(xyz[1]),
        zs=put(xyz[2]), cls=put(cls), ths=put(th.reshape(rows, B)), tls=put(tl.reshape(rows, B)))
    ds = ResidentDataset(
        devices=[dev], block_size=B, n_blocks=rows, headers=[h], files=[f],
        file_idx=np.zeros(rows, np.int32), nvs=nvs, block_start=np.arange(rows) * B,
        shards=[shard], total_points=int(nvs.sum()),
    )
    inside = valid.copy()
    for a in range(3):
        inside &= (xyz[a] >= lo[a]) & (xyz[a] <= hi[a])
    kernel = "class_count_words" if B % 4 == 0 else "class_count_multi"
    for plan, entry, want in (
        (QueryPlan(bounds=BoundsQuery(box)), "bbox_count_multi", inside.sum()),
        (QueryPlan(classification=ClassQuery(6)), kernel, (valid & (cls == 6)).sum()),
        (QueryPlan(time_range=TimeRangeQuery(12.5, 60.25)), "time_count_multi",
         (valid & (times >= 12.5) & (times < 60.25)).sum()),
    ):
        before = dict(TP.launches)
        assert ds.count(plan) == int(want) > 0
        launched = {k: v - before[k] for k, v in TP.launches.items() if v != before[k]}
        assert launched == {entry: 1}


def _profiled_events(fn, tmp_path) -> list[dict]:
    """The complete events of a CPU and CUDA torch.profiler trace of fn(),
    the card synchronized before the profiler stops."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def test_count_entries_are_the_predicate_count_span(dev, tmp_path):
    """Under a profiler the CUDA branch of each count entry a resident count
    calls is one predicate.count span around its launch, and a count request
    on the card is serve.parse, resident.operands, predicate.count and
    resident.readback, disjoint and in that order."""
    from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset
    from adhoc_queries_pointclouds_torch.serve import handle_request

    rng = np.random.default_rng(20)
    cls = _class_case(rng, 7, 4096)
    calls = [(TP.bbox_count_multi_kernel, _raw(rng, 4, 4096)),
             (TP.class_count_multi_kernel, cls),
             (TP.class_count_words_kernel, (cls[0].view(np.int32), *cls[1:])),
             (TP.time_count_multi_kernel, _time_raw_case(rng, 6, 4096))]
    operands = [[torch.from_numpy(a).to(dev) for a in args] for _, args in calls]
    for (fn, _), args in zip(calls, operands):  # built and warm before the trace
        fn(*args)
    events = _profiled_events(lambda: [fn(*args) for (fn, _), args in zip(calls, operands)],
                              tmp_path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e["name"] == "predicate.count")
    launches = [e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]]
    assert len(spans) == len(calls)
    for s0, s1 in spans:
        assert any(s0 <= t <= s1 for t in launches)

    synth.write_dataset(tmp_path, n_files=2, points_per_file=20_000, seed=5, formats=("last",))
    ds = ResidentDataset.load(tmp_path / "last", devices=[dev], block_size=1 << 13)
    req = {"bounds": [100200.0, 200300.0, 10.0, 100900.0, 200900.0, 70.0]}
    want = handle_request(ds, dict(req), str(tmp_path / "last"))["count"]
    got = []
    events = _profiled_events(
        lambda: got.append(handle_request(ds, dict(req), str(tmp_path / "last"))), tmp_path)
    assert got[0]["count"] == want > 0
    order = ("serve.parse", "resident.operands", "predicate.count", "resident.readback")
    spans = []
    for name in order:
        (ev,) = [e for e in events if e["name"] == name]
        spans.append((ev["ts"], ev["ts"] + ev["dur"]))
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start


def test_two_processes_on_cuda_match_one_cpu_process(dev, tmp_path):
    """tools/dist2.py with --device cuda: two worker processes in a gloo
    group, process i on card i % the card count (both on one card where
    there is one), run every query kind of the harness; their counts and
    written files equal one process's on the CPU (the plain versions), and
    together they launched the count, mask, compaction and density
    kernels."""
    from adhoc_queries_pointclouds_torch import _build
    from adhoc_queries_pointclouds_torch.tools import dist2

    _build.library()  # built once here, before the workers load it
    dist2.write_datasets(tmp_path / "data")
    queries = dist2.default_queries(tmp_path / "data", tmp_path / "out")
    got = dist2.run_workers(queries, procs=2, device="cuda", timeout=600.0)
    cpu_queries = dist2.default_queries(tmp_path / "data", tmp_path / "out_cpu")
    (want,) = dist2.run_workers(cpu_queries, procs=1, device="cpu", timeout=600.0)
    dist2.compare(queries, got, want["queries"])
    n_cards = torch.cuda.device_count()
    assert [w["device"] for w in got] == [f"cuda:{pid % n_cards}" for pid in range(2)]
    assert want["launches"] == {}
    launched = {}
    for w in got:
        for name, n in w["launches"].items():
            launched[name] = launched.get(name, 0) + n
    # a density block with few hits ships its hits' raw x, y, z alone
    for names in (["bbox_count_multi"], ["bbox_count_packed"], ["class_count_words"],
                  ["class_count_dict"], ["time_count_multi"], ["time_count_packed"],
                  ["mask_bbox_packed"], ["compact_bits"],
                  ["density_leaders", "density_leaders_packed"],
                  ["density_candidates", "density_candidates_packed"]):
        assert sum(launched.get(name, 0) for name in names) > 0, (names, launched)
    assert sum(w["queries"]["indexed_count"]["index_skipped_blocks"] for w in got) > 0


def test_two_shards_a_process_on_one_card_match_run_query(dev, tmp_path):
    """process_devices("cuda", 2) at one process on a one-card machine is
    [cuda:0, cuda:0] (card_layout wraps), and distributed_count over those
    shards equals run_query on the card and on the CPU, every launch on
    card 0."""
    from adhoc_queries_pointclouds_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("the layout wraps onto one card on a one-card machine")
    devices = distributed.process_devices("cuda", 2)
    assert devices == [dev, dev]
    assert distributed.global_device_count(devices) == 2
    synth.write_dataset(tmp_path, n_files=3, points_per_file=40_000, seed=17,
                        formats=("last",), clustered=True, point_format=3)
    data = tmp_path / "last"
    box = parse_aabb("100200;200300;10;102500;200800;60")
    TP.reset_launches()
    for plan in (QueryPlan(bounds=BoundsQuery(box)), QueryPlan(classification=ClassQuery(6)),
                 QueryPlan(time_range=TimeRangeQuery(0.1, 0.6))):
        kw = dict(block_size=1 << 13)
        got = distributed.distributed_count(data, plan, devices=devices, **kw)
        assert got == engine.run_query(data, plan, device="cuda", **kw).match_count
        assert got == engine.run_query(data, plan, device="cpu", **kw).match_count > 0
    assert TP.device_launches and {card for _, card in TP.device_launches} == {0}

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no jax, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers: kernel and plain version must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_torch import engine, host
from adhoc_queries_pointclouds_torch.ops import compact as TC
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from adhoc_queries_pointclouds_torch import index as index_mod
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery,
    ClassQuery,
    QueryPlan,
    TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb

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


def _time_packed_case(rng, K, B, widths):
    """Blocks of encoded times packed at the step's widths with per-block
    bases, and residual-space queries, as the engine makes them."""
    kh, kl = widths
    planes = [np.zeros((K, host.packed_row_width(k, B)), np.uint8) for k in widths]
    qs = np.zeros((K, 4), np.int32)
    for j in range(K):
        cols = []
        for k in widths:
            if k >= 32:
                cols.append((rng.integers(I32.min, I32.max, B, endpoint=True).astype(np.int32), 0))
            else:
                base = int(rng.integers(I32.min, I32.max - (1 << k)))
                cols.append(((base + rng.integers(0, 1 << k, B)).astype(np.int32), base))
        (th, bh), (tl, bl) = cols
        host.pack_bits_into(planes[0][j], th, kh, bh, B)
        host.pack_bits_into(planes[1][j], tl, kl, bl, B)
        a, b = sorted(rng.choice(B, 2, replace=False))
        q_enc = np.array([th[a], tl[a], th[b], tl[b]], np.int64)
        qs[j] = host._packed_time_query(q_enc, np.array([bh, bl], np.int64))
    nvs = rng.integers(1, B + 1, K).astype(np.int32)
    nvs[0] = B
    nvs[-1] = 0
    return (*planes, qs, nvs)


@pytest.mark.parametrize("widths", [(0, 0), (4, 12), (20, 28), (28, 28), (32, 32), (32, 4),
                                    (0, 32), (12, 20)])
@pytest.mark.parametrize("B", [4096, 4104])
def test_time_packed_kernel_matches_plain(dev, widths, B):
    rng = np.random.default_rng(sum(widths) * 7 + B)
    args = _time_packed_case(rng, 5, B, widths)
    got, ref = _both(TP.time_count_packed_kernel, args, dev, widths, B)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("k", [8, 16, 24, 32])
def test_time_packed_kernel_byte_planes_only(dev, k):
    rng = np.random.default_rng(k + 1)
    B = 4099
    args = _time_packed_case(rng, 3, B, (k, k))
    got, ref = _both(TP.time_count_packed_kernel, args, dev, (k, k), B)
    assert torch.equal(got, ref)


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


def _mask_both(fn, args, dev, *extra):
    """BitMask of the kernel on the card and of the plain version on the
    CPU, field by field equal; returns the plain one."""
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = fn(*(t.to(dev) for t in cpu), *extra)
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


@pytest.mark.parametrize("widths", [(0, 0, 0), (4, 4, 4), (12, 20, 28), (32, 32, 32),
                                    (3, 17, 31)])
@pytest.mark.parametrize("B", [4096, 4104, 8192 * 2 + 264])
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
    for k in (1, 2, 4, 8):
        dargs = _dict_case(rng, 5, B, k)
        got, ref = _mask_both(TP.class_mask_bits_dict, dargs, dev, k, B)
        _compact_both(dev, got, ref, dargs[-1], B)


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
    _mask_both(TP.class_mask_bits_dict, _dict_case(rng, 5, B, 8), dev, 8, B)


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

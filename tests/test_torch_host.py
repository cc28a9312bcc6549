"""The port's copies of host helpers are pinned to their JAX-package originals.

host.py copies helpers out of modules that import jax; parallel/pipeline.py
is a byte-for-byte copy of the JAX package's (its package __init__ imports
jax). Each copy must give byte-identical output to its original on the same
random inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as E
from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_tpu.parallel import pipeline as jax_pipeline
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.parallel import pipeline as torch_pipeline

I32 = np.iinfo(np.int32)
ROOT = Path(__file__).resolve().parent.parent


def _equal_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_pipeline_is_a_byte_copy():
    src = ROOT / "adhoc_queries_pointclouds_tpu" / "parallel" / "pipeline.py"
    dst = ROOT / "adhoc_queries_pointclouds_torch" / "parallel" / "pipeline.py"
    assert src.read_bytes() == dst.read_bytes()


@pytest.mark.parametrize("v", [0, 1, 2, 255, 256, 2**20 - 1, 2**31 - 1, 2**32 - 1])
def test_bits_width(v):
    assert host.bits_width(v) == P.bits_width(v)


@pytest.mark.parametrize("k", [0, 4, 12, 20, 28, 32])
def test_residual_u32(k):
    rng = np.random.default_rng(k)
    col = rng.integers(I32.min, I32.max, 1000, endpoint=True).astype(np.int32)
    for base in (0, int(col.min()), -12345):
        _equal_arrays(host.residual_u32(col, k, base), P.residual_u32(col, k, base))


@pytest.mark.parametrize("k", [0, 3, 4, 8, 12, 17, 20, 28, 32])
@pytest.mark.parametrize("n", [4096, 4093, 1])  # full block, ragged tail
def test_pack_bits_into(k, n):
    rng = np.random.default_rng(1000 * k + n)
    B = 4096
    if k == 32:
        col, base = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32), 0
    else:
        base = int(rng.integers(-2**30, 2**30))
        col = (base + rng.integers(0, 1 << k, n)).astype(np.int32) if k else np.full(n, base, np.int32)
    w = host.packed_row_width(k, B)
    assert w == P.packed_row_width(k, B)
    got = np.full(w, 0xA5, np.uint8)
    ref = np.full(w, 0xA5, np.uint8)
    host.pack_bits_into(got, col, k, base, B)
    P.pack_bits_into(ref, col, k, base, B)
    _equal_arrays(got, ref)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pack_bits_into_u8(k):
    rng = np.random.default_rng(k)
    B = 2048
    col = rng.integers(0, 1 << k, B - 5).astype(np.uint8)
    got = np.zeros(host.packed_row_width(k, B), np.uint8)
    ref = np.zeros_like(got)
    host.pack_bits_into(got, col, k, 0, B)
    P.pack_bits_into(ref, col, k, 0, B)
    _equal_arrays(got, ref)


@pytest.mark.parametrize("span", [0, 1, 15, 16, 2**20, 2**27, 2**28, 2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("block_size", [4096, 4099])
def test_residual_width_and_packed_cols(span, block_size):
    rng = np.random.default_rng(span % 1000)
    lo = int(I32.min) if span > 2**29 else int(rng.integers(-2**29, 2**29))
    col = np.clip(lo + rng.integers(0, span + 1, 512, dtype=np.int64), I32.min, I32.max)
    col = col.astype(np.int32)
    col[0], col[-1] = lo, min(lo + span, int(I32.max))
    assert host._residual_width(col, block_size) == E._residual_width(col, block_size)
    pos = np.stack([col, col[::-1].copy(), np.roll(col, 7)], axis=1)
    got = host._packed_xyz_cols(pos, block_size)
    ref = E._packed_xyz_cols(pos, block_size)
    assert got.keys() == ref.keys()
    for key in ref:
        _equal_arrays(got[key], ref[key])


def _written(row, k, n, block_size):
    """The bytes of one packed row that hold the first n points."""
    nbytes, nbits, bb = k // 8, k % 8, block_size // 8
    parts = [row[p * block_size : p * block_size + n] for p in range(nbytes)]
    off = nbytes * block_size
    parts += [row[off + q * bb : off + q * bb + (n + 7) // 8] for q in range(nbits)]
    return np.concatenate(parts) if parts else row[:0]


def _tasks(rng, n_tasks, block_size, packed):
    tasks = []
    for j in range(n_tasks):
        n = int(rng.integers(1, block_size + 1))
        pos = np.stack([
            rng.integers(-2**20, 2**20, n).astype(np.int32) + int(rng.integers(-2**29, 2**29))
            for _ in range(3)
        ], axis=1)
        cols = host._packed_xyz_cols(pos, block_size) if packed else {
            "x": np.ascontiguousarray(pos[:, 0]),
        }
        tasks.append(jax_pipeline.BlockTask(j, 0, 0, n, cols))
    return tasks


@pytest.mark.parametrize("n_tasks", [1, 4])
@pytest.mark.parametrize("block_size", [1 << 16, 8192 + 8])
def test_stack_rows_and_planes(n_tasks, block_size):
    rng = np.random.default_rng(n_tasks)
    rows = n_tasks + 1  # one padding row
    raw = _tasks(rng, n_tasks, block_size, packed=False)
    got = host._stack_rows(raw, "x", rows, block_size, np.int32)
    ref = E._stack_rows(raw, "x", rows, block_size, np.int32)
    for j, t in enumerate(raw):  # padding content is never read
        _equal_arrays(got[j, : t.n_valid], ref[j, : t.n_valid])
    packed = _tasks(rng, n_tasks, block_size, packed=True)
    for axis, key in enumerate(("xp", "yp", "zp")):
        k = int(max(t.columns["w"][axis] for t in packed))
        got = host._stack_planes(packed, key, axis, rows, k, block_size)
        ref = E._stack_planes(packed, key, axis, rows, k, block_size)
        assert got.shape == ref.shape
        for j, t in enumerate(packed):  # plane bytes past n_valid are never read
            _equal_arrays(_written(got[j], k, t.n_valid, block_size),
                          _written(ref[j], k, t.n_valid, block_size))


@pytest.mark.parametrize("block_size", [100, 1 << 14])
def test_pack_range_tasks(block_size):
    rng = np.random.default_rng(block_size)
    for trial in range(20):
        cuts = np.sort(rng.choice(200_000, size=2 * int(rng.integers(1, 12)), replace=False))
        ranges = [(int(cuts[i]), int(cuts[i + 1])) for i in range(0, len(cuts), 2)]
        assert host._pack_range_tasks(trial, ranges, block_size) == \
            E._pack_range_tasks(trial, ranges, block_size)


@pytest.mark.parametrize("value", [None, "1", "0"])
def test_pack_transport_enabled(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("AQPC_PACK", raising=False)
    else:
        monkeypatch.setenv("AQPC_PACK", value)
    assert host._pack_transport_enabled() == E._pack_transport_enabled()


def test_block_feeder_copy_yields_the_same_blocks():
    rng = np.random.default_rng(3)
    data = {f: rng.integers(-1000, 1000, (50_000, 3)).astype(np.int32) for f in range(3)}

    def load(file_idx, start, stop):
        return {"pos": data[file_idx][start:stop]}

    def transform(file_idx, cols):
        return host._packed_xyz_cols(cols["pos"], 8192)

    tasks = [(0, 0, 0, 8192), (0, 1, 8192, 9000), (1, 0, ((10, 100), (500, 8000))),
             (2, 3, 40_000, 50_000)]
    bounds = {f: (np.full(3, -5, np.int32), np.full(3, 5, np.int32)) for f in range(3)}
    out = []
    for mod in (jax_pipeline, torch_pipeline):
        feeder = mod.BlockFeeder(tasks, load, 8192, file_bounds=bounds, workers=2,
                                 prefetch=2, pad=False, transform_fn=transform)
        out.append(list(feeder))
    assert len(out[0]) == len(out[1]) == len(tasks)
    for a, b in zip(*out):
        assert (a.file_idx, a.block_idx, a.start, a.n_valid, a.ranges) == \
            (b.file_idx, b.block_idx, b.start, b.n_valid, b.ranges)
        _equal_arrays(a.lo, b.lo)
        _equal_arrays(a.hi, b.hi)
        assert a.columns.keys() == b.columns.keys()
        for key in a.columns:
            _equal_arrays(a.columns[key], b.columns[key])


F64_EDGES = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -np.nan, 5e-324, -5e-324,
                      2.2250738585072014e-308, np.finfo(np.float64).max,
                      -np.finfo(np.float64).max, 1.0, -1.0, 1e5, 1e9 + 0.5])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_f64_sortable(seed):
    rng = np.random.default_rng(seed)
    t = np.concatenate([F64_EDGES, rng.normal(0, 10.0 ** (seed * 4), 5000),
                        rng.integers(0, 2**64, 500, dtype=np.uint64).view(np.float64)])
    got, ref = host.encode_f64_sortable(t), P.encode_f64_sortable(t)
    for a, b in zip(got, ref):
        _equal_arrays(a, b)
    for v in F64_EDGES:
        assert host.encode_f64_scalar(v) == P.encode_f64_scalar(v)


@pytest.mark.parametrize("native_codec", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("n_present", [1, 2, 3, 16, 17, 200, 256])
def test_class_dict_encode(monkeypatch, native_codec, n_present):
    from adhoc_queries_pointclouds_torch.shared import native

    if not native_codec:
        monkeypatch.setattr(native, "dict_encode_u8", lambda col: None)
    rng = np.random.default_rng(n_present)
    values = rng.choice(256, n_present, replace=False).astype(np.uint8)
    col = values[rng.integers(0, n_present, 10_000)]
    col[:n_present] = values  # every value present
    got, ref = host.class_dict_encode(col), P.class_dict_encode(col)
    for a, b in zip(got, ref):
        _equal_arrays(a, b)
    assert len(got[0]) == n_present


@pytest.mark.parametrize("block_size", [4096, 4099])
def test_class_dict_width(block_size):
    for n in range(0, 258):
        assert host.class_dict_width(n, block_size) == P.class_dict_width(n, block_size)


def test_pack_class_words():
    rng = np.random.default_rng(9)
    cls = rng.integers(0, 256, (3, 4096)).astype(np.uint8)
    _equal_arrays(host.pack_class_words(cls), P.pack_class_words(cls))


@pytest.mark.parametrize("target", [0, 2, 6, 7, 255])
@pytest.mark.parametrize("block_size", [4096, 4099])
def test_packed_class_cols(target, block_size):
    rng = np.random.default_rng(target)
    for classes in ([2], [2, 6], [1, 2, 3, 4, 5, 6], list(range(0, 256, 3))):
        cls = rng.choice(np.asarray(classes, np.uint8), 3000)
        got = host._packed_class_cols(cls, target, block_size)
        ref = E._packed_class_cols(cls, target, block_size)
        assert got.keys() == ref.keys()
        for key in ref:
            _equal_arrays(got[key], ref[key])


@pytest.mark.parametrize("spread", [0.0, 1e-9, 3e-3, 10.0, 1e6, 1e300])
@pytest.mark.parametrize("block_size", [4096, 4099])
def test_packed_time_cols_and_query(spread, block_size):
    rng = np.random.default_rng(int(spread) % 97)
    t = 1e5 + rng.uniform(0, spread, 3000)
    t[:2] = [-spread, spread]  # mixed signs: hi words span more than 28 bits
    th, tl = host.encode_f64_sortable(t)
    got = host._packed_time_cols(th, tl, block_size)
    ref = E._packed_time_cols(th, tl, block_size)
    assert got.keys() == ref.keys()
    for key in ref:
        _equal_arrays(got[key], ref[key])
    for a, b in [(-np.inf, np.inf), (1e5, 1e5 + spread / 2), (0.0, 0.0), (-1e308, -1e307)]:
        q_enc = np.asarray(host.encode_f64_scalar(a) + host.encode_f64_scalar(b), np.int32)
        _equal_arrays(host._packed_time_query(q_enc, got["base"]),
                      E._packed_time_query(q_enc, ref["base"]))

"""The port's bbox count against the JAX package's, on the CPU.

The port's wrappers run their plain PyTorch versions for CPU tensors; these
tests hold them against the Pallas kernels (in interpret mode) and the
XLA-fused packed count of the JAX package on the same numpy inputs. The
results are integer counts, so the tolerance is 0: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from test_torch_cuda import EDGE_WIDTHS, packed_bbox_edge_case

I32 = np.iinfo(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _raw_case(rng, K, B, full_range):
    """(K, B) int32 xyz, per-block boxes and ragged n_valid, with a padding
    row (lo=0, hi=-1, nv=0) last."""
    if full_range:
        xyz = [rng.integers(I32.min, I32.max, (K, B), endpoint=True).astype(np.int32)
               for _ in range(3)]
    else:
        xyz = [rng.integers(-5000, 5000, (K, B)).astype(np.int32) for _ in range(3)]
    los = rng.integers(-3000, 0, (K, 3)).astype(np.int32)
    his = rng.integers(0, 3000, (K, 3)).astype(np.int32)
    if full_range:
        los[0] = I32.min
        his[0] = I32.max
    nvs = rng.integers(0, B + 1, K).astype(np.int32)
    nvs[0] = B
    los[-1], his[-1], nvs[-1] = 0, -1, 0
    return (*xyz, los, his, nvs)


@pytest.mark.parametrize("full_range", [False, True])
def test_bbox_count_multi_matches_pallas(full_range):
    rng = np.random.default_rng(11 + full_range)
    K, B = 3, P.MIN_BLOCK_MULTIPLE
    args = _raw_case(rng, K, B, full_range)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(P.bbox_count_pallas_multi(*_j(*args)))
    got = TP.bbox_count_multi_kernel(*_t(*args))
    assert got.dtype == torch.int32 and got.shape == (K,)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TP.bbox_count_multi(*_t(*args)).numpy(), ref)
    assert ref[0] > 0 and ref[-1] == 0


@pytest.mark.parametrize("nv_case", ["full", "ragged", "zero"])
def test_bbox_count_single_matches_pallas(nv_case):
    rng = np.random.default_rng(21)
    B = P.MIN_BLOCK_MULTIPLE
    x, y, z = (rng.integers(-2**30, 2**30, B).astype(np.int32) for _ in range(3))
    lo = np.array([-2**29, -2**28, I32.min], np.int32)
    hi = np.array([2**29, 2**30, I32.max], np.int32)
    nv = np.int32({"full": B, "ragged": B - 12345, "zero": 0}[nv_case])
    ref = int(P.bbox_count_pallas(*_j(x, y, z, lo, hi, nv), interpret=True))
    got = TP.bbox_count(*_t(x, y, z, lo, hi, np.asarray(nv)))
    assert got.dim() == 0 and got.dtype == torch.int32
    assert int(got) == ref


def _packed_case(rng, K, B, widths):
    """Blocks packed by the host's own helpers: per-block bases, the step's
    max widths, residual-space bounds clipped as the engine clips them, one
    padding row."""
    cols, bases = [], []
    for _ in range(K):
        block = []
        base = []
        for k in widths:
            if k >= 32:
                col = rng.integers(I32.min, I32.max, B, endpoint=True).astype(np.int32)
                mn = 0
            else:
                mn = int(rng.integers(-2**30, 2**30))
                col = (mn + rng.integers(0, 1 << k, B, endpoint=False)).astype(np.int32) \
                    if k else np.full(B, mn, np.int32)
            block.append(col)
            base.append(mn)
        cols.append(block)
        bases.append(np.asarray(base, np.int64))
    planes = []
    for a, k in enumerate(widths):
        out = np.zeros((K, host.packed_row_width(k, B)), np.uint8)
        for j in range(K):
            host.pack_bits_into(out[j], cols[j][a], k, int(bases[j][a]), B)
        planes.append(out)
    lo_w = np.stack([[np.percentile(cols[j][a], 20) for a in range(3)] for j in range(K)])
    hi_w = np.stack([[np.percentile(cols[j][a], 90) for a in range(3)] for j in range(K)])
    los = np.clip(lo_w.astype(np.int64) - np.stack(bases), I32.min, I32.max).astype(np.int32)
    his = np.clip(hi_w.astype(np.int64) - np.stack(bases), I32.min, I32.max).astype(np.int32)
    nvs = rng.integers(1, B + 1, K).astype(np.int32)
    nvs[0] = B
    los[-1], his[-1], nvs[-1] = 0, -1, 0
    return (*planes, los, his, nvs), cols


@pytest.mark.parametrize("k", [0, 4, 8, 12, 16, 20, 24, 28, 32])
def test_bbox_count_packed_matches_jnp(k):
    rng = np.random.default_rng(100 + k)
    K, B = 4, 4096
    widths = (k, max(k - 4, 0), min(k + 4, 32))
    args, cols = _packed_case(rng, K, B, widths)
    ref = np.asarray(P.bbox_count_packed_jnp_multi(*_j(*args), widths, B))
    got = TP.bbox_count_packed_kernel(*_t(*args), widths, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the unpack alone rebuilds the residuals the reference rebuilds
    for a in range(3):
        np.testing.assert_array_equal(
            TP.unpack_bits(torch.from_numpy(args[a]), widths[a], B).numpy(),
            np.asarray(P.unpack_bits_jnp(jnp.asarray(args[a]), widths[a], B)),
        )
    assert ref[0] > 0 and ref[-1] == 0


@pytest.mark.parametrize("k", [8, 16, 24, 32])
def test_bbox_count_packed_byte_planes_only(k):
    """block_size % 8 != 0: the layout has byte planes only."""
    rng = np.random.default_rng(200 + k)
    K, B = 3, 4099
    widths = (k, k, k)
    args, _ = _packed_case(rng, K, B, widths)
    ref = np.asarray(P.bbox_count_packed_jnp_multi(*_j(*args), widths, B))
    np.testing.assert_array_equal(TP.bbox_count_packed_kernel(*_t(*args), widths, B).numpy(), ref)


@pytest.mark.parametrize("B", [4096, 4104])  # B % 128 == 0, and B % 8 == 0 only
@pytest.mark.parametrize("widths", EDGE_WIDTHS)
def test_bbox_count_packed_at_the_ends_of_residual_space_matches_jnp(widths, B):
    """Bounds at and beyond both ends of residual space, at widths that take
    every branch of the card kernel's compare: the plain version, the oracle
    the kernel is held to on the card, is itself held to the JAX package."""
    args = packed_bbox_edge_case(widths, B)
    ref = np.asarray(P.bbox_count_packed_jnp_multi(*_j(*args), widths, B))
    got = TP.bbox_count_packed_kernel(*_t(*args), widths, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0 and (ref == 0).any()


def test_k32_raw_words_wrap_into_sign_bit():
    """k == 32 with base 0: the top byte shifts into the int32 sign bit."""
    B = 64
    col = np.array([I32.min, -1, 0, 1, I32.max] * 12 + [-7] * 4, np.int32)
    row = np.zeros((1, host.packed_row_width(32, B)), np.uint8)
    host.pack_bits_into(row[0], col, 32, 0, B)
    got = TP.unpack_bits(torch.from_numpy(row), 32, B).numpy()[0]
    np.testing.assert_array_equal(got, col)
    np.testing.assert_array_equal(got, np.asarray(P.unpack_bits_jnp(jnp.asarray(row), 32, B))[0])


def test_cpu_calls_launch_no_kernel():
    TP.reset_launches()
    rng = np.random.default_rng(5)
    args = _raw_case(rng, 2, 1024, False)
    TP.bbox_count_multi_kernel(*_t(*args))
    assert TP.launches["bbox_count_multi"] == 0
    assert set(TP.launches.values()) == {0}


def test_unsupported_device_raises():
    x = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    lo = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    nv = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TP.bbox_count_multi_kernel(x, x, x, lo, lo, nv)

"""The port's class and GPS-time counts against the JAX package's, on the CPU.

The port's wrappers run their plain PyTorch versions for CPU tensors; these
tests hold them against the Pallas class kernels (in interpret mode) and the
XLA-fused dictionary and time counts of the JAX package, on the same numpy
inputs. The results are integer counts, so the tolerance is 0: exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adhoc_queries_pointclouds_tpu.ops import predicate as P
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.ops import predicate as TP

I32 = np.iinfo(np.int32)
B_PALLAS = 4 * P.MIN_BLOCK_MULTIPLE  # word rows of (e) are tile-aligned too


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _classes(rng, targets, B, share=0.3):
    """(K, B) u8 rows of all 256 values, about `share` of each equal to its
    row's target."""
    cls = rng.integers(0, 256, (len(targets), B)).astype(np.uint8)
    for j, t in enumerate(targets):
        cls[j, rng.random(B) < share] = t
    return cls


# ---------------------------------------------------------------- (c)-(f)


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
@pytest.mark.parametrize("kernel", ["u8", "words"])
def test_class_count_multi_matches_pallas(kernel, tail):
    """K=2 at the Pallas tile shape: a block whose n_valid ends at every
    alignment mod 4, and a padding row (n_valid 0)."""
    rng = np.random.default_rng(31 + tail)
    targets = np.array([6, 255], np.int32)
    cls = _classes(rng, targets, B_PALLAS)
    nvs = np.array([B_PALLAS - 4 - tail, 0], np.int32)
    col = cls if kernel == "u8" else cls.view(np.int32)
    pallas = P.class_count_pallas_multi if kernel == "u8" else P.class_count_packed_pallas_multi
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas(*_j(col, targets, nvs)))
    wrapper = TP.class_count_multi_kernel if kernel == "u8" else TP.class_count_words_kernel
    got = wrapper(*_t(col, targets, nvs))
    assert got.dtype == torch.int32 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), ref)
    want = np.count_nonzero(cls[0, : nvs[0]] == targets[0])
    assert ref[0] == want > 0 and ref[1] == 0


@pytest.mark.parametrize("group", range(8))
@pytest.mark.parametrize("kernel", ["u8", "words"])
def test_class_count_all_targets_match_pallas(kernel, group):
    """Every target value 0..255, 32 per call, with ragged n_valid."""
    rng = np.random.default_rng(group)
    targets = np.arange(32 * group, 32 * group + 32, dtype=np.int32)
    B = P.MIN_BLOCK_MULTIPLE if kernel == "u8" else B_PALLAS
    cls = _classes(rng, targets, B, share=0.05)
    nvs = rng.integers(0, B + 1, len(targets)).astype(np.int32)
    nvs[:4] = [B, B - 1, B - 2, B - 3]
    col = cls if kernel == "u8" else cls.view(np.int32)
    pallas = P.class_count_pallas_multi if kernel == "u8" else P.class_count_packed_pallas_multi
    plain = TP.class_count_multi if kernel == "u8" else TP.class_count_packed_multi
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas(*_j(col, targets, nvs)))
    np.testing.assert_array_equal(plain(*_t(col, targets, nvs)).numpy(), ref)
    want = [np.count_nonzero(cls[j, : nvs[j]] == targets[j]) for j in range(len(targets))]
    np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("nv_case", ["full", "tail1", "tail2", "tail3", "zero"])
def test_class_count_single_matches_pallas(nv_case):
    rng = np.random.default_rng(41)
    B = B_PALLAS
    cls = _classes(rng, [2], B)[0]
    nv = np.int32({"full": B, "tail1": B - 1, "tail2": B - 2, "tail3": B - 7,
                   "zero": 0}[nv_case])
    target = np.int32(2)
    ref_u8 = int(P.class_count_pallas(*_j(cls, target, nv), interpret=True))
    ref_w = int(P.class_count_packed_pallas(*_j(cls.view(np.int32), target, nv),
                                            interpret=True))
    got_u8 = TP.class_count(*_t(cls, np.asarray(target), np.asarray(nv)))
    got_w = TP.class_count_packed(*_t(cls.view(np.int32), np.asarray(target), np.asarray(nv)))
    assert got_u8.dim() == 0 and got_w.dim() == 0 and got_w.dtype == torch.int32
    assert int(got_u8) == ref_u8 == int(got_w) == ref_w


def test_class_count_words_matches_jnp_for_any_int32_target():
    """The word form replicates a target outside 0..255 as uint32(t) *
    0x01010101, as the JAX word count does; the u8 form matches nothing."""
    rng = np.random.default_rng(5)
    targets = np.array([256, -1, 0x01020304, I32.min, I32.max, -256, 511, 6], np.int32)
    cls = _classes(rng, [1, 255, 4, 0, 255, 0, 255, 6], 4096)
    nvs = np.array([4096, 4095, 4094, 4093, 17, 0, 4096, 4096], np.int32)
    words = cls.view(np.int32)
    ref = np.asarray(P.class_count_packed_jnp_multi(*_j(words, targets, nvs)))
    np.testing.assert_array_equal(TP.class_count_packed_multi(*_t(words, targets, nvs)).numpy(),
                                  ref)
    ref_u8 = np.asarray(P.class_count_jnp_multi(*_j(cls, targets, nvs)))
    np.testing.assert_array_equal(TP.class_count_multi(*_t(cls, targets, nvs)).numpy(), ref_u8)


# ---------------------------------------------------------------- (i)


def _dict_case(rng, K, B, n_present, miss):
    """K blocks dictionary-coded by the host's own helpers; the last target
    a miss (len(dict)) when asked, the last row padding."""
    rows, targets, ks = [], [], []
    for j in range(K):
        values = rng.choice(256, n_present, replace=False).astype(np.uint8)
        cls = values[rng.integers(0, n_present, B)]
        target = 300 if (miss and j == K - 2) else int(values[j % n_present])
        if target > 255:
            target = int(np.setdiff1d(np.arange(256), values)[0])
        cols = host._packed_class_cols(cls, target, B)
        rows.append(cols)
        targets.append(int(cols["t"][0]))
        ks.append(int(cols["w"][0]))
    k = max(ks)
    cp = np.zeros((K, host.packed_row_width(k, B)), np.uint8)
    for j, cols in enumerate(rows):
        host.pack_bits_into(cp[j], cols["clsp"], k, 0, B)
    nvs = rng.integers(1, B + 1, K).astype(np.int32)
    nvs[0] = B
    nvs[-1] = 0
    return (cp, np.asarray(targets, np.int32), nvs), k


@pytest.mark.parametrize("n_present", [2, 3, 4, 5, 16, 17, 200, 256])
@pytest.mark.parametrize("B", [4096, 4099])  # 4099: byte planes only
def test_class_count_dict_matches_jnp(n_present, B):
    rng = np.random.default_rng(n_present * 10 + B)
    (cp, targets, nvs), k = _dict_case(rng, 5, B, n_present, miss=n_present < 256)
    assert k == (8 if B % 8 else {2: 1, 3: 2, 4: 2, 5: 4, 16: 4}.get(n_present, 8))
    ref = np.asarray(P.class_count_dict_jnp_multi(*_j(cp, targets, nvs), k, B))
    got = TP.class_count_dict_kernel(*_t(cp, targets, nvs), k, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0] > 0 and ref[-1] == 0
    if n_present < 256:
        assert targets[-2] == n_present and ref[-2] == 0  # the miss code


# ---------------------------------------------------------------- (h)


F64_EDGES = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324,
                      2.2250738585072014e-308, -2.2250738585072014e-308, 1e5, -1e5])


def _encode(t):
    th, tl = host.encode_f64_sortable(t.reshape(-1))
    return th.reshape(t.shape), tl.reshape(t.shape)


def _oracle(t, a, b, nv):
    return int(np.count_nonzero((t[:nv] >= a) & (t[:nv] < b)))


RANGES = [
    (-np.inf, np.inf),
    (-0.0, 0.0),  # empty: start == end
    (0.0, 5e-324),  # holds both signed zeros, not the subnormal
    (-5e-324, 1e-300),
    (1e5, 1e5 + 1.0),
    (np.inf, np.inf),
    (-1e5, np.inf),
]


@pytest.mark.parametrize("rng_idx", range(len(RANGES)))
def test_time_count_multi_matches_jnp(rng_idx):
    rng = np.random.default_rng(rng_idx)
    K, B = 4, 4096
    t = np.stack([rng.uniform(1e5, 1e5 + 2.0, B), rng.normal(0, 1e-300, B),
                  rng.choice(F64_EDGES, B), rng.uniform(-2e5, 2e5, B)])
    th, tl = _encode(t)
    a, b = RANGES[rng_idx]
    q = np.asarray(host.encode_f64_scalar(a) + host.encode_f64_scalar(b), np.int32)
    qs = np.tile(q, (K, 1))
    nvs = np.array([B, B - 1, B - 5, 0], np.int32)
    ref = np.asarray(P.time_count_jnp_multi(*_j(th, tl, qs, nvs)))
    got = TP.time_count_multi_kernel(*_t(th, tl, qs, nvs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the encoding gives the f64 answer (NaN matches no finite range)
    for j in range(K - 1):
        assert ref[j] == _oracle(t[j], a, b, nvs[j])


def test_time_count_equal_hi_words():
    """Queries whose hi words equal the points': the lo words decide."""
    rng = np.random.default_rng(3)
    B = 1024
    t = 1e5 + np.sort(rng.uniform(0, 1e-3, B))
    th, tl = _encode(t[None])
    assert len(np.unique(th)) == 1
    qs = np.array([[th[0, 0], tl[0, 100], th[0, 0], tl[0, 900]],
                   [th[0, 0], tl[0, 900], th[0, 0], tl[0, 100]],
                   [th[0, 0], tl[0, 5], th[0, 0], tl[0, 5]]], np.int32)
    th3, tl3 = np.repeat(th, 3, 0), np.repeat(tl, 3, 0)
    nvs = np.full(3, B, np.int32)
    ref = np.asarray(P.time_count_jnp_multi(*_j(th3, tl3, qs, nvs)))
    np.testing.assert_array_equal(TP.time_count_multi(*_t(th3, tl3, qs, nvs)).numpy(), ref)
    assert list(ref) == [800, 0, 0]


def _time_blocks(rng, spreads, B):
    """One block per spread of f64 times around 1e5, packed by the host's
    own helpers at the step's max widths, with residual-space queries."""
    blocks = []
    for s in spreads:
        t = 1e5 + rng.uniform(0, s, B) if s < 1e5 else rng.uniform(-s, s, B)
        blocks.append((t, host._packed_time_cols(*_encode(t), B)))
    kh = max(int(c["w"][0]) for _, c in blocks)
    kl = max(int(c["w"][1]) for _, c in blocks)
    thp = np.zeros((len(blocks), host.packed_row_width(kh, B)), np.uint8)
    tlp = np.zeros((len(blocks), host.packed_row_width(kl, B)), np.uint8)
    for j, (_, c) in enumerate(blocks):
        host.pack_bits_into(thp[j], c["thp"], kh, int(c["base"][0]), B)
        host.pack_bits_into(tlp[j], c["tlp"], kl, int(c["base"][1]), B)
    return blocks, thp, tlp, (kh, kl)


@pytest.mark.parametrize("spreads", [
    (0.0, 0.0),  # widths 0: every point equal
    (1e-9, 1e-6),  # lo words of a few bits
    (3e-3, 1e-3),  # lo words up to 28 bits
    (10.0, 1e-6),  # lo words of 32 bits (base 0)
    (3e5, 10.0),  # mixed signs: hi words of 32 bits (base 0)
])
@pytest.mark.parametrize("B", [4096, 4099])  # 4099: byte planes only
def test_time_count_packed_matches_jnp(spreads, B):
    rng = np.random.default_rng(int(sum(spreads) * 1e3) % 1000 + B)
    blocks, thp, tlp, widths = _time_blocks(rng, spreads, B)
    if spreads == (3e-3, 1e-3) and B % 8 == 0:
        assert widths[1] == 28
    if spreads[0] >= 10.0:
        assert 32 in widths
    for a, b in [(-np.inf, np.inf), (1e5 + 1e-3, 1e5 + 2e-3), (1e5, 1e5), (1e5 + 5.0, 2e5),
                 (-1e6, -1e5)]:
        q_enc = np.asarray(host.encode_f64_scalar(a) + host.encode_f64_scalar(b), np.int64)
        qs = np.stack([host._packed_time_query(q_enc, c["base"]) for _, c in blocks])
        nvs = np.array([B, B - 3], np.int32)
        ref = np.asarray(P.time_count_packed_jnp_multi(*_j(thp, tlp, qs, nvs), widths, B))
        got = TP.time_count_packed_kernel(*_t(thp, tlp, qs, nvs), widths, B)
        np.testing.assert_array_equal(got.numpy(), ref)
        for j, (t, _) in enumerate(blocks):
            assert ref[j] == _oracle(t, a, b, nvs[j])


def test_cpu_calls_of_new_wrappers_launch_no_kernel():
    TP.reset_launches()
    rng = np.random.default_rng(6)
    cls = _classes(rng, [3, 4], 64)
    t, nv = np.array([3, 4], np.int32), np.array([64, 10], np.int32)
    TP.class_count_multi_kernel(*_t(cls, t, nv))
    TP.class_count_words_kernel(*_t(cls.view(np.int32), t, nv))
    TP.class_count_dict_kernel(*_t(cls, t, nv), 8, 64)
    th, tl = _encode(rng.uniform(0, 1, (2, 64)))
    qs = np.tile(np.asarray(host.encode_f64_scalar(0.2) + host.encode_f64_scalar(0.7),
                            np.int32), (2, 1))
    TP.time_count_multi_kernel(*_t(th, tl, qs, nv))
    TP.time_count_packed_kernel(*_t(cls, cls, qs, nv), (8, 8), 64)
    assert set(TP.launches.values()) == {0}

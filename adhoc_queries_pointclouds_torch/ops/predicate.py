"""Predicates over stacked (K, B) point blocks: counts and collect bit masks,
plain versions and kernels.

Each kernel has a plain PyTorch version beside it, with the JAX package's
argument layout. The wrappers dispatch on the tensors' device:

  - CPU tensors go to the plain version;
  - CUDA tensors go to the hand-written kernel in csrc/, or raise.

Nothing falls back from the kernel to the plain version. A wrapper counts
its kernel launches in ``launches`` (CPU calls do not count), and by card
in ``device_launches``, so a run can show that the main path went through
the kernels, and on which cards. The CUDA branch of each count entry that
a resident count calls is the profiler span "predicate.count"
(utils/timing.py span): its checks, bounds, output and launch.

The predicates are the reference hot loops' (query/src/search/las.rs:101-146,
last.rs:253-291): int32 compares of raw local coordinates against per-block
int32 bounds, u8 class equality, and the half-open GPS-time range compared
on the order-preserving (hi, lo) int32 encoding of the f64 times; padding is
masked by row index < n_valid.

The collect path takes each predicate as a bit mask (BitMask): bit j of
int32 word w of a block is row 32w + j, with the block's hit count and
its hits per chunk of CHUNK_WORDS words, which ops/compact.py turns into
hit indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..host import packed_row_width
from ..utils.timing import span

# kernel name -> launches on CUDA tensors since the last reset_launches();
# each name is also the kernel's C entry point without its "aqpc_" prefix
launches = {
    "bbox_count_multi": 0,
    "bbox_count_packed": 0,
    "class_count_multi": 0,
    "class_count_words": 0,
    "class_count_dict": 0,
    "time_count_multi": 0,
    "time_count_packed": 0,
    "mask_bbox": 0,
    "mask_bbox_packed": 0,
    "mask_class": 0,
    "mask_class_dict": 0,
    "mask_time": 0,
    "mask_time_packed": 0,
    "compact_bits": 0,
    "compact_bits_gather": 0,
    "density_leaders": 0,
    "density_leaders_packed": 0,
    "density_candidates": 0,
    "density_candidates_packed": 0,
    "bbox_probe_acc": 0,
    "bbox_probe_acc_nomask": 0,
}


# (kernel name, card index) -> launches on that card since the last
# reset_launches()
device_launches: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    device_launches.clear()


# ---------------------------------------------------------------------------
# plain versions (counterparts of adhoc_queries_pointclouds_tpu/ops/predicate.py)
# ---------------------------------------------------------------------------


def _valid(nvs, block_size: int, device):
    """(K, B) bool: row index < n_valid."""
    idx = torch.arange(block_size, dtype=torch.int32, device=device)
    return idx[None, :] < nvs[:, None]


def bbox_mask_multi(xs, ys, zs, los, his, nvs):
    """(K, B) coords + (K, 3) bounds + (K,) valid -> (K, B) bool
    (bbox_mask_jnp_multi, predicate.py:261-268)."""
    m = _valid(nvs, xs.shape[1], xs.device)
    m &= (xs >= los[:, 0:1]) & (xs <= his[:, 0:1])
    m &= (ys >= los[:, 1:2]) & (ys <= his[:, 1:2])
    m &= (zs >= los[:, 2:3]) & (zs <= his[:, 2:3])
    return m


def bbox_count_multi(xs, ys, zs, los, his, nvs):
    """(K,) int32 counts (bbox_count_jnp_multi, predicate.py:271-272)."""
    return bbox_mask_multi(xs, ys, zs, los, his, nvs).sum(dim=1, dtype=torch.int32)


def unpack_bits(packed, k: int, block_size: int):
    """(K, nbytes*B + nbits*(B//8)) u8 -> (K, B) int32 residuals
    (unpack_bits_jnp, predicate.py:480-496). Byte plane p is shifted by 8p
    in int32, so at k == 32 the top byte wraps into the sign bit exactly as
    in the reference; bit planes are in little bit order."""
    rows = packed.shape[0]
    nbytes, nbits = k // 8, k % 8
    r = torch.zeros((rows, block_size), dtype=torch.int32, device=packed.device)
    for p in range(nbytes):
        plane = packed[:, p * block_size : (p + 1) * block_size]
        r |= plane.to(torch.int32) << (8 * p)
    if nbits:
        off = nbytes * block_size
        bb = block_size // 8
        shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
        for q in range(nbits):
            bp = packed[:, off + q * bb : off + (q + 1) * bb].to(torch.int32)
            bits = (bp[:, :, None] >> shifts) & 1  # little bit order
            r |= bits.reshape(rows, block_size) << (8 * nbytes + q)
    return r


def bbox_mask_packed_multi(xp, yp, zp, los, his, nvs, widths, block_size):
    """Packed-transport mask -> (K, B) bool (bbox_mask_packed_jnp_multi,
    predicate.py:508-512): widths (kx, ky, kz); los/his in residual space."""
    xs = unpack_bits(xp, widths[0], block_size)
    ys = unpack_bits(yp, widths[1], block_size)
    zs = unpack_bits(zp, widths[2], block_size)
    return bbox_mask_multi(xs, ys, zs, los, his, nvs)


def bbox_count_packed_multi(xp, yp, zp, los, his, nvs, widths, block_size):
    """Packed-transport count (bbox_count_packed_jnp_multi,
    predicate.py:499-505)."""
    mask = bbox_mask_packed_multi(xp, yp, zp, los, his, nvs, widths, block_size)
    return mask.sum(dim=1, dtype=torch.int32)


def class_mask_multi(cls, targets, nvs):
    """(K, B) class values + (K,) int32 targets -> (K, B) bool
    (class_mask_jnp_multi, predicate.py:247-249)."""
    return _valid(nvs, cls.shape[1], cls.device) & (cls.to(torch.int32) == targets[:, None])


def class_count_multi(cls, targets, nvs):
    """(K,) int32 counts (class_count_jnp_multi, predicate.py:275-278)."""
    return class_mask_multi(cls, targets, nvs).sum(dim=1, dtype=torch.int32)


# 4-points-per-word class count (predicate.py:609-680). torch's uint32 ops
# are partial, so the u32 word math runs in int64, masked to 32 bits after
# every ~ and +.
_REP = 0x01010101
_LOW7 = 0x7F7F7F7F
_U32 = 0xFFFFFFFF


def _packed_match_ones(w, rep):
    """u32 words (in int64) -> 0x01 at each byte equal to the target's."""
    v = w ^ rep
    t = ~((((v & _LOW7) + _LOW7) & _U32) | v | _LOW7) & _U32
    return t >> 7


def _byte_sum(ones):
    """Sum the four 0..1 byte fields of each word -> int32 (0..4)."""
    t = (ones + (ones >> 16)) & _U32
    t = (t + (t >> 8)) & _U32
    return (t & 0xFF).to(torch.int32)


def _packed_keep(nv, word_idx):
    """0x01 at each byte position < n_valid (little-endian order)."""
    c = torch.clamp(nv - 4 * word_idx, 0, 4)
    s = (4 - c) * 4
    return (torch.full_like(s, _REP) >> s) >> s  # two <=16-bit shifts: never >= 32


def class_count_packed_multi(words, targets, nvs):
    """(K, W) int32 words = the (K, 4W) u8 class column viewed little-endian,
    (K,) targets and valid counts in points -> (K,) int32
    (class_count_packed_jnp_multi, predicate.py:673-680)."""
    w = words.to(torch.int64) & _U32
    rep = (((targets.to(torch.int64) & _U32) * _REP) & _U32)[:, None]
    ones = _packed_match_ones(w, rep)
    widx = torch.arange(words.shape[1], dtype=torch.int64, device=words.device)
    ones &= _packed_keep(nvs.to(torch.int64)[:, None], widx[None, :])
    return _byte_sum(ones).sum(dim=1, dtype=torch.int32)


def class_mask_dict_multi(cp, targets, nvs, k: int, block_size: int):
    """Dictionary-coded class mask: (K, planes) u8 codes at k bits and
    per-block target CODES -> (K, B) bool (class_mask_dict_jnp_multi,
    predicate.py:604-606)."""
    return class_mask_multi(unpack_bits(cp, k, block_size), targets, nvs)


def class_count_dict_multi(cp, targets, nvs, k: int, block_size: int):
    """(K,) int32 counts (class_count_dict_jnp_multi, predicate.py:597-601)."""
    return class_mask_dict_multi(cp, targets, nvs, k, block_size).sum(dim=1, dtype=torch.int32)


def time_mask_multi(ths, tls, qs, nvs):
    """(K, B) encoded times + (K, 4) encoded half-open range -> (K, B) bool
    (time_mask_jnp_multi, predicate.py:235-240)."""
    ge = (ths > qs[:, 0:1]) | ((ths == qs[:, 0:1]) & (tls >= qs[:, 1:2]))
    lt = (ths < qs[:, 2:3]) | ((ths == qs[:, 2:3]) & (tls < qs[:, 3:4]))
    return ge & lt & _valid(nvs, ths.shape[1], ths.device)


def time_count_multi(ths, tls, qs, nvs):
    """(K,) int32 counts (time_count_jnp_multi, predicate.py:243-244)."""
    return time_mask_multi(ths, tls, qs, nvs).sum(dim=1, dtype=torch.int32)


def time_mask_packed_multi(thp, tlp, qs, nvs, widths, block_size):
    """Packed-transport GPS-time mask -> (K, B) bool
    (time_mask_packed_jnp_multi, predicate.py:537-540): widths (k_hi, k_lo);
    qs in residual space."""
    ths = unpack_bits(thp, widths[0], block_size)
    tls = unpack_bits(tlp, widths[1], block_size)
    return time_mask_multi(ths, tls, qs, nvs)


def time_count_packed_multi(thp, tlp, qs, nvs, widths, block_size):
    """Packed-transport GPS-time count (time_count_packed_jnp_multi,
    predicate.py:529-534)."""
    mask = time_mask_packed_multi(thp, tlp, qs, nvs, widths, block_size)
    return mask.sum(dim=1, dtype=torch.int32)


# Bit masks of the collect path. A chunk is CHUNK_WORDS words (8192 rows):
# the mask kernels write each chunk's hit count, which ops/compact.py's
# kernel sums to place the chunk's hits (csrc/collect.cuh).
CHUNK_WORDS = 256


def mask_words(block_size: int) -> int:
    return (block_size + 31) // 32


def mask_chunks(block_size: int) -> int:
    return (mask_words(block_size) + CHUNK_WORDS - 1) // CHUNK_WORDS


class BitMask(NamedTuple):
    """One collect step's predicate over K blocks of B rows."""

    bits: torch.Tensor  # (K, ceil(B/32)) int32: bit j of word w is row 32w + j
    counts: torch.Tensor  # (K,) int32 hits per block
    chunks: torch.Tensor  # (K, mask_chunks(B)) int32 hits per chunk


def pack_mask_bits(mask) -> BitMask:
    """(K, B) bool -> BitMask: the plain version of every bit-mask kernel's
    output. Rows past B in the last word are 0."""
    k_blocks, block_size = mask.shape
    n_words, n_chunks = mask_words(block_size), mask_chunks(block_size)
    padded = torch.zeros((k_blocks, n_chunks * CHUNK_WORDS * 32), dtype=torch.bool,
                         device=mask.device)
    padded[:, :block_size] = mask
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, dtype=torch.int64, device=mask.device)
    words = (padded[:, : n_words * 32].view(k_blocks, n_words, 32) * weights).sum(-1)
    bits = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    chunks = padded.view(k_blocks, n_chunks, -1).sum(-1, dtype=torch.int32)
    return BitMask(bits, mask.sum(dim=1, dtype=torch.int32), chunks)


def unpack_mask_bits(bits, block_size: int):
    """(K, W) int32 mask words -> (K, B) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    rows = (bits.to(torch.int64)[:, :, None] >> shifts) & 1
    return rows.reshape(bits.shape[0], -1)[:, :block_size].bool()


def bbox_probe_acc(x, y, z, lo, hi, n_valid):
    """(n,) int32 x/y/z, (3,) int32 lo/hi, 0-d or (1,) int32 n_valid -> 0-d
    int32 closed-box count of rows < n_valid (_bbox_kernel_acc,
    tools/bboxprobe.py:60-84)."""
    nv = n_valid.reshape(1)
    return bbox_count_multi(x[None], y[None], z[None], lo[None], hi[None], nv)[0]


def bbox_probe_acc_nomask(x, y, z, lo, hi):
    """The count over all n rows (_bbox_kernel_acc_nomask,
    tools/bboxprobe.py:87-107)."""
    nv = torch.full((1,), x.shape[0], dtype=torch.int32, device=x.device)
    return bbox_count_multi(x[None], y[None], z[None], lo[None], hi[None], nv)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_planes(t, name: str, k: int, k_max: int, k_blocks: int, block_size: int,
                  device) -> None:
    """A (K, row width) u8 plane stack of k-bit residuals."""
    if not 0 <= k <= k_max:
        raise ValueError(f"{name} width {k} outside [0, {k_max}]")
    if k % 8 and block_size % 8:
        raise ValueError(f"{name}: bit planes need block_size % 8 == 0, got {block_size}")
    _check(t, name, torch.uint8, (k_blocks, packed_row_width(k, block_size)), device)


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no count kernel for tensors on {t.device}")


def _rows(t: torch.Tensor, name: str) -> tuple[int, int]:
    if t.dim() != 2:
        raise ValueError(f"{name} must be (K, B), got shape {tuple(t.shape)}")
    return t.shape


def run(name: str, tensors: tuple, sizes: tuple) -> None:
    """Run entry point aqpc_<name>(tensor pointers..., sizes..., stream) on
    the current stream of the tensors' device, with that device current, so
    that the stream, cudaGetDevice and the occupancy queries that size the
    persistent grids (csrc/block_count.cuh) all name the tensors' card;
    raise on a CUDA error, else count the launch, by name and by card."""
    dev = tensors[0].device
    fn = getattr(_build.library(), f"aqpc_{name}")
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in tensors), *sizes,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"aqpc_{name}")
    launches[name] += 1
    key = (name, dev.index)
    device_launches[key] = device_launches.get(key, 0) + 1


def _launch(name: str, tensors: tuple, sizes: tuple) -> torch.Tensor:
    """Run a count entry point into a zeroed (K,) int32 output, K = sizes[0]."""
    out = torch.zeros(sizes[0], dtype=torch.int32, device=tensors[0].device)
    run(name, (*tensors, out), sizes)
    return out


# (device index, stream) -> the workspace of the counts that write their
# output (the class entries): one 64-bit ticket word a row, zeroed when made
# or grown; every launch leaves it zeroed (csrc/collect.cuh row_done).
# Launches on one stream run in order, so one workspace a stream suffices.
_workspaces: dict = {}


def _workspace(k_blocks: int, dev) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    work = _workspaces.get(key)
    if work is None or work.numel() < k_blocks:
        work = torch.zeros(k_blocks, dtype=torch.int64, device=dev)
        _workspaces[key] = work
    return work


def _launch_written(name: str, tensors: tuple, sizes: tuple) -> torch.Tensor:
    """Run a count entry point that writes its (K,) int32 output, K =
    sizes[0], through the stream's workspace: no fill of the output."""
    dev = tensors[0].device
    out = torch.empty(sizes[0], dtype=torch.int32, device=dev)
    run(name, (*tensors, out, _workspace(sizes[0], dev)), sizes)
    return out


def _launch_mask(name: str, tensors: tuple, sizes: tuple) -> BitMask:
    """Run a mask entry point into a fresh BitMask for K = sizes[0] blocks of
    B = sizes[1] rows."""
    k_blocks, block_size = sizes[0], sizes[1]
    dev = tensors[0].device
    out = BitMask(
        torch.empty((k_blocks, mask_words(block_size)), dtype=torch.int32, device=dev),
        torch.zeros(k_blocks, dtype=torch.int32, device=dev),
        torch.empty((k_blocks, mask_chunks(block_size)), dtype=torch.int32, device=dev),
    )
    run(name, (*tensors, *out), sizes)
    return out


def _bounds(los, his, k_blocks: int, device) -> torch.Tensor:
    _check(los, "los", torch.int32, (k_blocks, 3), device)
    _check(his, "his", torch.int32, (k_blocks, 3), device)
    return torch.cat((los, his), dim=1)  # (K, 6): [lo0, lo1, lo2, hi0, hi1, hi2]


def bbox_count_multi_kernel(xs, ys, zs, los, his, nvs):
    """(K, B) int32 x/y/z, (K, 3) int32 los/his, (K,) int32 n_valid ->
    (K,) int32 closed-box counts. Replaces bbox_count_pallas_multi
    (predicate.py:305-333); kernel in csrc/bbox_count.cu."""
    if not _on_cuda(xs):
        return bbox_count_multi(xs, ys, zs, los, his, nvs)
    with span("predicate.count"):
        k_blocks, block_size = _rows(xs, "xs")
        dev = xs.device
        for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
            _check(t, name, torch.int32, (k_blocks, block_size), dev)
        _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
        bounds = _bounds(los, his, k_blocks, dev)
        return _launch("bbox_count_multi", (xs, ys, zs, bounds, nvs), (k_blocks, block_size))


def bbox_count(x, y, z, lo, hi, n_valid):
    """One (B,) block -> 0-d int32 count: the K=1 launch of the multi kernel
    (replaces bbox_count_pallas, predicate.py:107-135). lo/hi are (3,) int32
    tensors and n_valid a 0-d or (1,) int32 tensor on x's device."""
    counts = bbox_count_multi_kernel(
        x[None], y[None], z[None], lo[None], hi[None], n_valid.reshape(1)
    )
    return counts[0]


def bbox_count_packed_kernel(xp, yp, zp, los, his, nvs, widths, block_size: int):
    """Packed-transport count: (K, row width) u8 plane stacks per axis at
    widths (kx, ky, kz), residual-space (K, 3) int32 los/his, (K,) int32
    n_valid -> (K,) int32. Replaces the XLA-fused unpack_bits_jnp +
    bbox_count_packed_jnp_multi (predicate.py:480-505); kernel in
    csrc/bbox_count_packed.cu."""
    if not _on_cuda(xp):
        return bbox_count_packed_multi(xp, yp, zp, los, his, nvs, widths, block_size)
    k_blocks = xp.shape[0]
    dev = xp.device
    kx, ky, kz = (int(w) for w in widths)
    for name, t, k in (("xp", xp, kx), ("yp", yp, ky), ("zp", zp, kz)):
        _check_planes(t, name, k, 32, k_blocks, block_size, dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    bounds = _bounds(los, his, k_blocks, dev)
    return _launch("bbox_count_packed", (xp, yp, zp, bounds, nvs),
                   (k_blocks, block_size, kx, ky, kz))


def _class_operands(col, dtype, targets, nvs) -> tuple[int, int]:
    k_blocks, width = _rows(col, "class column")
    dev = col.device
    _check(col, "class column", dtype, (k_blocks, width), dev)
    _check(targets, "targets", torch.int32, (k_blocks,), dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    return k_blocks, width


def class_count_multi_kernel(cls, targets, nvs):
    """(K, B) u8 class values, (K,) int32 targets, (K,) int32 n_valid ->
    (K,) int32 counts of class == target. Any B. Replaces
    class_count_pallas_multi (predicate.py:355-380); kernel in
    csrc/class_count.cu."""
    if not _on_cuda(cls):
        return class_count_multi(cls, targets, nvs)
    with span("predicate.count"):
        k_blocks, block_size = _class_operands(cls, torch.uint8, targets, nvs)
        return _launch_written("class_count_multi", (cls, targets, nvs), (k_blocks, block_size))


def class_count(cls, class_value, n_valid):
    """One (B,) u8 block -> 0-d int32 count: the K=1 launch of (c)
    (replaces class_count_pallas, predicate.py:156-181). class_value and
    n_valid are 0-d or (1,) int32 tensors on cls's device."""
    return class_count_multi_kernel(cls[None], class_value.reshape(1), n_valid.reshape(1))[0]


def class_count_words_kernel(words, targets, nvs):
    """(K, W) int32 words (the (K, 4W) u8 class column viewed
    little-endian), (K,) int32 targets, (K,) int32 n_valid in points ->
    (K,) int32. Replaces class_count_packed_pallas_multi
    (predicate.py:754-779); kernel in csrc/class_count.cu."""
    if not _on_cuda(words):
        return class_count_packed_multi(words, targets, nvs)
    with span("predicate.count"):
        k_blocks, w = _class_operands(words, torch.int32, targets, nvs)
        return _launch_written("class_count_words", (words, targets, nvs), (k_blocks, w))


def class_count_packed(words, class_value, n_valid):
    """One (W,) int32 word block -> 0-d int32 count: the K=1 launch of (e)
    (replaces class_count_packed_pallas, predicate.py:703-730)."""
    return class_count_words_kernel(words[None], class_value.reshape(1),
                                    n_valid.reshape(1))[0]


def class_count_dict_kernel(cp, targets, nvs, k: int, block_size: int):
    """Dictionary-coded class count: (K, row width) u8 planes of k-bit codes
    (k <= 8), (K,) int32 target codes (len(dict) on a miss), (K,) int32
    n_valid -> (K,) int32. Replaces the XLA-fused
    class_count_dict_jnp_multi (predicate.py:597-601); kernel in
    csrc/class_count_dict.cu."""
    if not _on_cuda(cp):
        return class_count_dict_multi(cp, targets, nvs, k, block_size)
    k_blocks = cp.shape[0]
    dev = cp.device
    _check_planes(cp, "cp", int(k), 8, k_blocks, block_size, dev)
    _check(targets, "targets", torch.int32, (k_blocks,), dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    return _launch_written("class_count_dict", (cp, targets, nvs),
                           (k_blocks, block_size, int(k)))


def _time_query(qs, nvs, k_blocks: int, device) -> None:
    _check(qs, "qs", torch.int32, (k_blocks, 4), device)
    _check(nvs, "nvs", torch.int32, (k_blocks,), device)


def time_count_multi_kernel(ths, tls, qs, nvs):
    """(K, B) int32 encoded GPS-time hi/lo words, (K, 4) int32 encoded
    half-open ranges (q0h, q0l, q1h, q1l), (K,) int32 n_valid -> (K,) int32.
    Replaces the XLA-fused time_count_jnp_multi (predicate.py:235-244);
    kernel in csrc/time_count.cu."""
    if not _on_cuda(ths):
        return time_count_multi(ths, tls, qs, nvs)
    with span("predicate.count"):
        k_blocks, block_size = _rows(ths, "ths")
        dev = ths.device
        _check(ths, "ths", torch.int32, (k_blocks, block_size), dev)
        _check(tls, "tls", torch.int32, (k_blocks, block_size), dev)
        _time_query(qs, nvs, k_blocks, dev)
        return _launch("time_count_multi", (ths, tls, qs, nvs), (k_blocks, block_size))


def time_count_packed_kernel(thp, tlp, qs, nvs, widths, block_size: int):
    """Packed-transport GPS-time count: (K, row width) u8 plane stacks of the
    hi and lo words at widths (k_hi, k_lo), residual-space (K, 4) int32
    ranges, (K,) int32 n_valid -> (K,) int32. Replaces the XLA-fused
    time_count_packed_jnp_multi (predicate.py:529-534); kernel in
    csrc/time_count.cu."""
    if not _on_cuda(thp):
        return time_count_packed_multi(thp, tlp, qs, nvs, widths, block_size)
    k_blocks = thp.shape[0]
    dev = thp.device
    kh, kl = (int(w) for w in widths)
    _check_planes(thp, "thp", kh, 32, k_blocks, block_size, dev)
    _check_planes(tlp, "tlp", kl, 32, k_blocks, block_size, dev)
    _time_query(qs, nvs, k_blocks, dev)
    return _launch("time_count_packed", (thp, tlp, qs, nvs), (k_blocks, block_size, kh, kl))


# ---------------------------------------------------------------------------
# collect bit masks: one wrapper per collect kind, kernels in csrc/mask_bits.cu
# (the mask halves of mesh._collect_fn, parallel/mesh.py:229-291)
# ---------------------------------------------------------------------------


def bbox_mask_bits(xs, ys, zs, los, his, nvs) -> BitMask:
    """Raw-transport bbox: operands of bbox_count_multi_kernel -> BitMask
    (bbox_mask_jnp_multi, predicate.py:261-268)."""
    if not _on_cuda(xs):
        return pack_mask_bits(bbox_mask_multi(xs, ys, zs, los, his, nvs))
    k_blocks, block_size = _rows(xs, "xs")
    dev = xs.device
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        _check(t, name, torch.int32, (k_blocks, block_size), dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    bounds = _bounds(los, his, k_blocks, dev)
    return _launch_mask("mask_bbox", (xs, ys, zs, bounds, nvs), (k_blocks, block_size))


def bbox_mask_bits_packed(xp, yp, zp, los, his, nvs, widths, block_size: int) -> BitMask:
    """Packed-transport bbox: operands of bbox_count_packed_kernel -> BitMask
    (bbox_mask_packed_jnp_multi, predicate.py:508-512)."""
    if not _on_cuda(xp):
        return pack_mask_bits(
            bbox_mask_packed_multi(xp, yp, zp, los, his, nvs, widths, block_size))
    k_blocks = xp.shape[0]
    dev = xp.device
    kx, ky, kz = (int(w) for w in widths)
    for name, t, k in (("xp", xp, kx), ("yp", yp, ky), ("zp", zp, kz)):
        _check_planes(t, name, k, 32, k_blocks, block_size, dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    bounds = _bounds(los, his, k_blocks, dev)
    return _launch_mask("mask_bbox_packed", (xp, yp, zp, bounds, nvs),
                        (k_blocks, block_size, kx, ky, kz))


def class_mask_bits(cls, targets, nvs) -> BitMask:
    """(K, B) u8 class rows, (K,) int32 targets and n_valid -> BitMask
    (class_mask_jnp_multi, predicate.py:247-249; the collect path never
    takes the word view)."""
    if not _on_cuda(cls):
        return pack_mask_bits(class_mask_multi(cls, targets, nvs))
    k_blocks, block_size = _class_operands(cls, torch.uint8, targets, nvs)
    return _launch_mask("mask_class", (cls, targets, nvs), (k_blocks, block_size))


def class_mask_bits_dict(cp, targets, nvs, k: int, block_size: int) -> BitMask:
    """Dictionary-coded class: operands of class_count_dict_kernel ->
    BitMask (class_mask_dict_jnp_multi, predicate.py:604-606)."""
    if not _on_cuda(cp):
        return pack_mask_bits(class_mask_dict_multi(cp, targets, nvs, k, block_size))
    k_blocks = cp.shape[0]
    dev = cp.device
    _check_planes(cp, "cp", int(k), 8, k_blocks, block_size, dev)
    _check(targets, "targets", torch.int32, (k_blocks,), dev)
    _check(nvs, "nvs", torch.int32, (k_blocks,), dev)
    return _launch_mask("mask_class_dict", (cp, targets, nvs), (k_blocks, block_size, int(k)))


def time_mask_bits(ths, tls, qs, nvs) -> BitMask:
    """Raw GPS time: operands of time_count_multi_kernel -> BitMask
    (time_mask_jnp_multi, predicate.py:235-240)."""
    if not _on_cuda(ths):
        return pack_mask_bits(time_mask_multi(ths, tls, qs, nvs))
    k_blocks, block_size = _rows(ths, "ths")
    dev = ths.device
    _check(ths, "ths", torch.int32, (k_blocks, block_size), dev)
    _check(tls, "tls", torch.int32, (k_blocks, block_size), dev)
    _time_query(qs, nvs, k_blocks, dev)
    return _launch_mask("mask_time", (ths, tls, qs, nvs), (k_blocks, block_size))


def time_mask_bits_packed(thp, tlp, qs, nvs, widths, block_size: int) -> BitMask:
    """Packed GPS time: operands of time_count_packed_kernel -> BitMask
    (time_mask_packed_jnp_multi, predicate.py:537-540)."""
    if not _on_cuda(thp):
        return pack_mask_bits(time_mask_packed_multi(thp, tlp, qs, nvs, widths, block_size))
    k_blocks = thp.shape[0]
    dev = thp.device
    kh, kl = (int(w) for w in widths)
    _check_planes(thp, "thp", kh, 32, k_blocks, block_size, dev)
    _check_planes(tlp, "tlp", kl, 32, k_blocks, block_size, dev)
    _time_query(qs, nvs, k_blocks, dev)
    return _launch_mask("mask_time_packed", (thp, tlp, qs, nvs),
                        (k_blocks, block_size, kh, kl))


# ---------------------------------------------------------------------------
# the bbox probe variants (kernel g), kernels in csrc/bbox_probe.cu
# ---------------------------------------------------------------------------

# partial-sum slots of the probe's persistent grid: more than SMs x
# resident CTAs on any current card
PROBE_SLOTS = 4096


def _probe_operands(x, y, z, lo, hi) -> torch.Tensor:
    n = x.shape[0]
    dev = x.device
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check(t, name, torch.int32, (n,), dev)
    _check(lo, "lo", torch.int32, (3,), dev)
    _check(hi, "hi", torch.int32, (3,), dev)
    return torch.cat((lo, hi))


def _launch_probe(name: str, tensors: tuple, n: int) -> torch.Tensor:
    dev = tensors[0].device
    partials = torch.empty(PROBE_SLOTS, dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    run(name, (*tensors, partials, ticket, out), (n, PROBE_SLOTS))
    return out[0]


def bbox_probe_acc_kernel(x, y, z, lo, hi, n_valid):
    """(n,) int32 x/y/z, (3,) int32 lo/hi, 0-d or (1,) int32 n_valid -> 0-d
    int32: the count of rows < n_valid in the box, accumulated per thread
    over a persistent grid and reduced once. Replaces _bbox_kernel_acc
    (tools/bboxprobe.py:60-84, pallas_call at :114)."""
    if not _on_cuda(x):
        return bbox_probe_acc(x, y, z, lo, hi, n_valid)
    bounds = _probe_operands(x, y, z, lo, hi)
    nv = n_valid.reshape(1)
    _check(nv, "n_valid", torch.int32, (1,), x.device)
    return _launch_probe("bbox_probe_acc", (x, y, z, bounds, nv), x.shape[0])


def bbox_probe_acc_nomask_kernel(x, y, z, lo, hi):
    """As bbox_probe_acc_kernel over all n rows, with no n_valid. Replaces
    _bbox_kernel_acc_nomask (tools/bboxprobe.py:87-107)."""
    if not _on_cuda(x):
        return bbox_probe_acc_nomask(x, y, z, lo, hi)
    bounds = _probe_operands(x, y, z, lo, hi)
    return _launch_probe("bbox_probe_acc_nomask", (x, y, z, bounds), x.shape[0])

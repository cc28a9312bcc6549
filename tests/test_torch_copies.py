"""The port's own copies of the numpy-only host modules are byte copies.

The port imports nothing of the JAX package, so it carries its own copy of
each host module it needs, under the same name and layout. Every import in
them is relative, so each copy is the original file unchanged: the file
compares below pin that, and the copies then need no review of their own.
native/__init__.py differs in its build function alone (the port compiles
to a temporary name and renames, and unlinks no other build); the
comparison leaves that function out, and the codec case builds the port's
library and requires the JAX package's bytes from every entry point the
port calls.
"""

import filecmp
import re
from pathlib import Path

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import native as jax_native
from adhoc_queries_pointclouds_tpu.formats import open_point_cloud as jax_open
from adhoc_queries_pointclouds_tpu.formats import synth as jax_synth
from adhoc_queries_pointclouds_torch import native as torch_native
from adhoc_queries_pointclouds_torch.formats import open_point_cloud as torch_open
from adhoc_queries_pointclouds_torch.formats import synth as torch_synth

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "adhoc_queries_pointclouds_tpu"
PORT = ROOT / "adhoc_queries_pointclouds_torch"
COPIES = [
    "utils/__init__.py", "utils/aabb.py", "utils/timing.py",
    "models/__init__.py", "models/query.py",
    "native/aqpc_native.cpp", "native/laszip.cpp",
    "formats/__init__.py", "formats/lz4py.py", "formats/las.py", "formats/last.py",
    "formats/lazer.py", "formats/laz.py", "formats/synth.py",
    "index.py", "sinks.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    assert filecmp.cmp(JAX / rel, PORT / rel, shallow=False), rel


def _without_build_function(path: Path) -> str:
    text = path.read_text()
    cut = re.sub(r"(?ms)^def _build_if_needed\(\).*?(?=^def )", "", text, count=1)
    assert cut != text and "def _build_if_needed" not in cut
    return cut


def test_native_bindings_differ_in_the_build_function_alone():
    rel = "native/__init__.py"
    assert _without_build_function(JAX / rel) == _without_build_function(PORT / rel)
    build = re.search(r"(?ms)^def _build_if_needed\(\).*?(?=^def )", (PORT / rel).read_text())
    assert "os.replace(" in build.group(0) and "unlink()" not in build.group(0)


def test_port_imports_are_relative():
    """No copied module names either package: that is what lets the copies
    stay byte-identical."""
    for rel in COPIES + ["native/__init__.py"]:
        if rel.endswith(".py"):
            for line in (PORT / rel).read_text().splitlines():
                if re.match(r"\s*(import|from)\s", line):
                    assert "adhoc_queries_pointclouds" not in line, (rel, line)


@pytest.fixture(scope="module")
def both_codecs():
    if not (jax_native.available() and torch_native.available()):
        pytest.skip("native codec unavailable")
    jax_so, port_so = Path(jax_native.load()._name), Path(torch_native.load()._name)
    assert jax_so.parent == JAX / "native" and port_so.parent == PORT / "native"
    assert jax_so.name == port_so.name  # the same sources: the same hash
    assert not list((PORT / "native").glob("*.tmp"))
    return jax_native, torch_native


def test_codec_entry_points_give_the_jax_packages_bytes(both_codecs):
    """pack_bits, pack_bits_u8, dict_encode_u8, format_points, xxh32 and the
    LZ4 frame codec on the same random inputs."""
    rng = np.random.default_rng(41)
    n, block = 10_000, 16_384
    col = rng.integers(-(2**20), 2**20, n).astype(np.int32)
    base = int(col.min())
    codes = rng.integers(0, 7, n).astype(np.uint8)
    pos = rng.uniform(-1e5, 1e5, (n, 3))
    rgb = rng.integers(0, 65536, (n, 3)).astype(np.uint16)
    cls = rng.integers(0, 256, n).astype(np.uint8)
    inten = rng.integers(0, 65536, n).astype(np.uint16)
    blob = np.repeat(rng.integers(0, 256, 3000).astype(np.uint8), 7).tobytes()
    outs = []
    for nat in both_codecs:
        got = []
        for k in (0, 4, 12, 21, 28, 32):
            row = np.zeros((k // 8) * block + (k % 8) * (block // 8), np.uint8)
            assert nat.pack_bits(col, base if k < 32 else 0, k, row, block)
            got.append(row)
        for k in (1, 3, 8):
            row = np.zeros((k // 8) * block + (k % 8) * (block // 8), np.uint8)
            assert nat.pack_bits_u8(codes, k, row, block)
            got.append(row)
        got.extend(nat.dict_encode_u8(cls))
        got.append(np.frombuffer(nat.format_points(pos, rgb, cls, inten).encode(), np.uint8))
        got.append(np.asarray([nat.xxh32(blob), nat.xxh32(blob, 7)], np.uint32))
        frame = nat.lz4_frame_compress(blob)
        got.append(np.frombuffer(frame, np.uint8))
        got.append(nat.lz4_frame_decompress(frame, len(blob)))
        assert got[-1].tobytes() == blob
        outs.append(got)
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("point_format", [2, 3])
def test_files_written_and_read_by_either_package_agree(both_codecs, tmp_path, point_format):
    """The LAZ and LAZER encoders and decoders run in the native library:
    the same synthetic dataset written through each package is byte-identical
    in every format, and each package reads the other's files to the same
    columns."""
    del both_codecs
    formats = ("las", "last", "lazer", "laz")
    for name, synth in (("jax", jax_synth), ("torch", torch_synth)):
        synth.write_dataset(tmp_path / name, n_files=1, points_per_file=20_000, seed=13,
                            formats=formats, clustered=True, point_format=point_format)
    columns = ["position", "classification", "color", "intensity"]
    if point_format == 3:
        columns.append("gps_time")
    for fmt in formats:
        a, b = tmp_path / "jax" / fmt / f"file_0.{fmt}", tmp_path / "torch" / fmt / f"file_0.{fmt}"
        assert filecmp.cmp(a, b, shallow=False), fmt
        r_jax, r_port = jax_open(b), torch_open(a)
        assert r_jax.point_count == r_port.point_count == 20_000
        for c in columns:
            np.testing.assert_array_equal(r_jax.column(c), r_port.column(c))
        np.testing.assert_array_equal(r_jax.positions_world(), r_port.positions_world())
        r_jax.close()
        r_port.close()

"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from yardstick import harness, spec

PROGRAM = "adhoc_queries_pointclouds_torch"

# every module of the benchmark and the program's modules that a run loads
# (engine: the streamed deployment's path)
_LOAD_ALL = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import control, sets
from yardstick import harness, las, measure, reference, spec, synth, trace, traffic
from adhoc_queries_pointclouds_torch import engine, serve
from adhoc_queries_pointclouds_torch.parallel import resident
for m in spec.load_spec()["end_to_end"] + spec.load_spec()["per_layer"]:
    spec.reader(m["name"])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_LOAD_REFERENCE = """
import sys
sys.path[:0] = [{bench!r}]
from yardstick import reference
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(program: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", program.format(
        bench=str(spec.BENCH_DIR), root=str(spec.ROOT))], capture_output=True, text=True,
        check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    names = top_level_names(_LOAD_ALL)
    assert PROGRAM in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_names(_LOAD_REFERENCE)
    assert "torch" in names
    assert PROGRAM not in names and not names & set(harness.FORBIDDEN)


@pytest.mark.parametrize("module", ["reference.py", "synth.py", "measure.py", "trace.py",
                                    "traffic.py", "las.py"])
def test_yardstick_sources_import_no_program(module):
    tree = ast.parse((spec.BENCH_DIR / "yardstick" / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in (PROGRAM, *harness.FORBIDDEN), (module, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_helper", sys)
    monkeypatch.setitem(sys.modules, "adhoc_queries_pointclouds_tpu_extra", sys)
    found = harness.forbidden_modules()
    assert "jaxlike_helper" not in found and "adhoc_queries_pointclouds_tpu_extra" not in found
    monkeypatch.setitem(sys.modules, "adhoc_queries_pointclouds_tpu.ops", sys)
    assert "adhoc_queries_pointclouds_tpu" in harness.forbidden_modules()


def test_no_card_no_result(tmp_path):
    """Without the cell's cards run.py prints no result and exits 3."""
    proc = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                           "doc.count", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    if "torch.cuda.is_available() is false" not in proc.stderr:
        pytest.skip("a card is visible")
    assert proc.returncode == 3 and proc.stdout.strip() == ""

"""What the harness and the reference load: never ``jax`` nor the JAX
package ``repro`` (top-level names compared whole: the program is
``repro_torch``), and the reference nothing of the program."""
import subprocess
import sys

from conftest import ROOT

from portbench import run

REFERENCE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from portbench import graphgen, inputs, refcore, yardstick, harness
for path in sorted((harness.HERE / "configs").glob("*.py")):
    harness.load_module(path, "ref_" + path.stem)
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "repro", "repro_torch"}}))
"""

RUN = """
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from conftest import tiny
from portbench import harness, inputs
import pathlib, tempfile
inputs.CACHE = pathlib.Path(tempfile.mkdtemp())
harness.run("han.imdb", 1, 0.05, True, "cpu", cell=tiny("han.imdb"))
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "repro"}}), "repro_torch" in top)
"""


def _py(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program_nor_jax():
    assert _py(REFERENCE.format(src=str(ROOT / "src"), root=str(ROOT))) == "[]"


def test_a_run_loads_the_program_and_no_jax():
    out = _py(RUN.format(src=str(ROOT / "src"), root=str(ROOT), tests=str(ROOT / "portbench" / "tests")))
    assert out == "[] True"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]

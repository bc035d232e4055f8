"""Import hygiene of the port: ``repro_torch`` (its ``serve/`` included) and
``chip_smoke.py`` import neither JAX nor anything of the reference package
``repro`` (the machine with the GPU has no JAX, and the port keeps its own
copy of what it needs, the JAX-free ``repro.serve`` modules too)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_jax_or_reference_imports(tmp_path):
    assert len(PORT_FILES) > 10
    assert (ROOT / "chip_smoke.py").is_file()
    port = ROOT / "src" / "repro_torch"
    for sub in ("core", "data", "kernels", "configs", "layers", "models", "launch", "serve"):
        assert port / sub / "__init__.py" in PORT_FILES, sub
    for mod in ("clock", "faults", "frontend", "health", "load", "plane", "queueing"):
        assert port / "serve" / f"{mod}.py" in PORT_FILES, mod
    assert port / "kernels" / "topk_decode_attention" / "ops.py" in PORT_FILES
    assert port / "kernels" / "topk_select" / "ops.py" in PORT_FILES
    for mod in ("data/datasets.py", "data/sgb_cache.py", "core/dtypes.py"):
        assert port / mod in PORT_FILES, mod
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom repro.core import flows\n"
        "import repro_torch\nfrom repro_torch.core import flows\n"
    )
    found = [mod for _, mod in _imports(probe) if _forbidden(mod)]
    assert found == ["jax.numpy", "repro.core"]
    bad = [
        (str(path.relative_to(ROOT)), line, mod)
        for path in PORT_FILES
        for line, mod in _imports(path)
        if _forbidden(mod)
    ]
    assert not bad, f"forbidden imports: {bad}"


def test_cpu_forward_loads_neither_jax_nor_reference(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.core import pipeline\n"
        "from repro_torch.core.flows import FlowConfig\n"
        "from repro_torch.data import datasets, sgb_cache\n"
        "task = pipeline.prepare('han', 'acm', scale=0.03, device='cpu')\n"
        "out = task.compile(FlowConfig('fused_kernel', prune_k=4))(task.params)\n"
        "assert out.shape == (task.batch.num_targets, task.spec.num_classes)\n"
        f"dump = datasets.save_hetgraph(task.graph, {str(tmp_path / 'dump')!r}, metapaths=task.metapaths)\n"
        "for _ in range(2):\n"
        "    t = pipeline.prepare('rgat', dump, bucket_sizes='auto', device='cpu',\n"
        f"                         sgb_cache_dir={str(tmp_path / 'cache')!r})\n"
        "    t.compile(FlowConfig('fused_kernel', prune_k=4))(t.params)\n"
        "from repro_torch import serve\n"
        "fe = serve.ServeFrontend(task.compile(FlowConfig('fused_kernel', prune_k=4)), task.params,\n"
        "                         clock=serve.FakeClock(), executor=serve.InlineExecutor())\n"
        "wl = serve.make_workload(9, task.batch.num_targets, seed=0)\n"
        "futs = serve.run_workload(fe, wl)\n"
        "assert all(f.result(0).shape == (len(w.targets), task.spec.num_classes) for w, f in zip(wl, futs))\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model\n"
        "import torch\n"
        "lm = build_model(get_config('gemma3-4b', smoke=True), device='cpu')\n"
        "lg, cache = lm.prefill(torch.zeros((1, 12), dtype=torch.long), max_len=14)\n"
        "lg, cache = lm.decode_step(lg.argmax(-1)[:, None], 12, cache)\n"
        "assert lg.shape == (1, 512)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout

"""Import hygiene of the port: ``repro_torch`` (its ``serve/`` and
``stream/`` included) and ``chip_smoke.py`` import neither JAX nor anything
of the reference package ``repro`` (the machine with the GPU has no JAX,
and the port keeps its own copy of what it needs, the JAX-free
``repro.serve`` modules too)."""
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
    for sub in ("core", "data", "kernels", "configs", "layers", "models", "launch", "serve", "stream",
                "distributed", "optim", "checkpoint", "runtime"):
        assert port / sub / "__init__.py" in PORT_FILES, sub
    for mod in ("clock", "faults", "frontend", "health", "load", "plane", "queueing"):
        assert port / "serve" / f"{mod}.py" in PORT_FILES, mod
    assert port / "kernels" / "topk_decode_attention" / "ops.py" in PORT_FILES
    assert port / "kernels" / "topk_select" / "ops.py" in PORT_FILES
    for mod in ("data/datasets.py", "data/sgb_cache.py", "core/dtypes.py", "core/ego.py",
                "stream/delta.py", "stream/merge.py", "stream/ingest.py", "distributed/sharding.py",
                "layers/moe.py", "configs/olmoe_1b_7b.py", "configs/qwen2_1_5b.py", "layers/rglru.py",
                "layers/rwkv.py", "configs/recurrentgemma_2b.py", "configs/rwkv6_3b.py",
                "configs/llama32_vision_90b.py", "configs/seamless_m4t_medium.py", "optim/adafactor.py",
                "data/tokens.py", "launch/steps.py", "launch/train.py", "checkpoint/manager.py",
                "runtime/straggler.py", "runtime/trainer.py", "distributed/compression.py", "launch/mesh.py",
                "npz.py", "distributed/probe.py", "launch/dryrun.py"):
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
        "import repro_torch.core.ego\n"
        "sess = task.compile(FlowConfig('fused_kernel', prune_k=4)).enable_ego(seed=0, sample=4)\n"
        "assert sess.query_ego(task.params, [0, 1]).shape == (2, task.spec.num_classes)\n"
        "from repro_torch.stream import StreamIngestor\n"
        "ing = StreamIngestor(task, sess)\n"
        "rep = ing.ingest({'AP': ([0, 1], [2, 3])})\n"
        "assert rep.version == 1 and ing.session(task.params).shape == (task.batch.num_targets, task.spec.num_classes)\n"
        "from repro_torch.distributed import sharding\n"
        "assert sharding.graph_mesh() is None\n"
        "t2 = pipeline.prepare('rgat', 'imdb', scale=0.03, device='cpu', shards=2)\n"
        "assert all((2, 8, 8) in sg._sharded for sg in t2.sgs)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model\n"
        "import torch\n"
        "lm = build_model(get_config('gemma3-4b', smoke=True), device='cpu')\n"
        "lg, cache = lm.prefill(torch.zeros((1, 12), dtype=torch.long), max_len=14)\n"
        "lg, cache = lm.decode_step(lg.argmax(-1)[:, None], 12, cache)\n"
        "assert lg.shape == (1, 512)\n"
        "lm = build_model(get_config('seamless-m4t-medium', smoke=True), device='cpu')\n"
        "ctx = torch.zeros((1, lm.ctx_len, lm.cfg.d_model))\n"
        "lg, cache = lm.prefill(torch.zeros((1, 12), dtype=torch.long), max_len=14, context=ctx)\n"
        "lg, cache = lm.decode_step(lg.argmax(-1)[:, None], 12, cache)\n"
        "assert lg.shape == (1, 256)\n"
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


def test_training_modules_load_neither_jax_reference_nor_triton(tmp_path):
    """The LM training modules and the mesh functions (``launch/mesh.py``)
    import, and two smoke training steps run on the CPU through the launcher, without loading JAX, the reference or
    ``triton`` and without starting a process (no kernel is built)."""
    code = (
        "import subprocess, sys\n"
        "started = []\n"
        "popen_init = subprocess.Popen.__init__\n"
        "def record(self, *a, **k):\n"
        "    started.append(a)\n"
        "    return popen_init(self, *a, **k)\n"
        "subprocess.Popen.__init__ = record\n"
        "import repro_torch.checkpoint.manager, repro_torch.data.tokens, repro_torch.distributed.compression\n"
        "import repro_torch.launch.steps, repro_torch.layers.flash, repro_torch.optim.adafactor\n"
        "import repro_torch.runtime.straggler, repro_torch.runtime.trainer\n"
        "import repro_torch.launch.mesh, torch.distributed\n"
        "assert not torch.distributed.is_initialized()  # importing the meshes starts no process group\n"
        "from repro_torch.launch import train\n"
        f"train.main(['--arch', 'qwen2-1.5b', '--smoke', '--device', 'cpu', '--steps', '2', '--seq-len', '16',\n"
        f"            '--global-batch', '4', '--ckpt-dir', {str(tmp_path / 'ckpt')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print('LOADED', bad, 'STARTED', len(started))\n"
        "sys.exit(1 if bad or started else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED [] STARTED 0" in proc.stdout and "[train] done" in proc.stdout


def test_dryrun_modules_load_neither_jax_nor_reference():
    """``distributed/probe.py`` and ``launch/dryrun.py`` import without CUDA,
    JAX or the reference, starting no process group; ``python -m
    repro_torch.launch.dryrun --device cuda`` on a machine without CUDA
    exits with a clear error and writes no record."""
    code = (
        "import sys\n"
        "import repro_torch.distributed.probe as probe, repro_torch.launch.dryrun as dryrun, torch\n"
        "import torch.distributed\n"
        "assert not torch.distributed.is_initialized() and not probe.probing()\n"
        "with probe.probe_mode():\n"
        "    assert probe.probing()\n"
        "assert dryrun.PEAK_FLOPS == 989e12 and dryrun.HBM_BW == 3.35e12 and dryrun.ICI_BW == 450e9\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print('LOADED', bad, torch.cuda.is_available())\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED [] False" in proc.stdout
    out = ROOT / "build" / "dryrun_no_cuda"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b", "--smoke",
                           "--shape", "decode_32k", "--device", "cuda", "--out", str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "--device cuda needs a CUDA device" in proc.stderr, proc.stdout + proc.stderr
    assert not out.exists()

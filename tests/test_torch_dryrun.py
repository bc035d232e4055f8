"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against real runs, on the CPU.

Every run that needs a world of its own runs in a process of its own, all
started at once by the ``runs`` fixture (``tests/torch_dryrun_cells.py``
for the port, ``tests/torch_dryrun_reference.py`` for the reference):

  * the analytic functions: ``model_flops`` and ``active_param_count`` of
    all ten full configs at the four shapes, and ``_probe_cfg`` at k 1 and
    2, ``accum`` 1 and 2, field for field, equal the reference's;
  * each cell of ``tests/test_dryrun_small.py`` run by the port on fake
    CPU tensors in a fake world ends ``ok``, its keys include the
    reference record's and its analytic fields equal those of the
    reference's ``run_cell`` (run with ``Auto`` mesh axes, under which its
    cells pass);
  * rank 0's fake FLOPs, bytes, collective bytes and counts by kind and
    memory on a (2, 2) mesh equal rank 0's counts on four ``gloo`` ranks
    running the same step on real tensors (qwen2-1.5b train at
    ``grad_accum`` 2; gemma3-4b pruned decode with and without
    ``hier_topk``);
  * the probe's fit equals a direct count of the probe config at the
    cell's depth (3 units) for a train cell at ``accum`` 1 and a decode
    cell; at ``accum`` 2 the FLOPs do, and the bytes and collective bytes
    are exactly bilinear in (depth, accum), which the reference's
    three-probe fit is not (``ROADMAP.md`` §3);
  * every smoke cell of all ten archs on a (2, 2, 2) mesh ends ``ok``, or
    ``skipped`` exactly where ``cell_supported`` skips.

Smoke configs, float32. Wall time ~45 s, the processes running side by side.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch_dryrun_cells as cells  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH_NAMES = ("chatglm3-6b", "gemma3-4b", "qwen2-1.5b", "qwen2-72b", "arctic-480b", "olmoe-1b-7b",
              "recurrentgemma-2b", "llama-3.2-vision-90b", "rwkv6-3b", "seamless-m4t-medium")
# the "archs" job's two halves, each about as long
HALVES = (("seamless-m4t-medium", "chatglm3-6b", "gemma3-4b", "olmoe-1b-7b", "qwen2-72b"),
          ("recurrentgemma-2b", "rwkv6-3b", "arctic-480b", "qwen2-1.5b", "llama-3.2-vision-90b"))
TIMEOUT = 300


def _start(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.Popen([sys.executable] + [str(a) for a in args], env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process started at once; the gloo ranks run while they do."""
    d = tmp_path_factory.mktemp("dryrun")
    cells_py, ref_py = ROOT / "tests" / "torch_dryrun_cells.py", ROOT / "tests" / "torch_dryrun_reference.py"
    procs = {
        "reference": _start([ref_py, d / "reference"], {
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1 --xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true"}),
        "small": _start([cells_py, "small", d / "small"]),
        "counts": _start([cells_py, "counts", d / "counts.json"]),
        **{f"archs{i}": _start([cells_py, "archs", d / "archs", *h]) for i, h in enumerate(HALVES)},
    }
    try:
        gloo = cells.spawn(str(tmp_path_factory.mktemp("dryrun_gloo")), timeout=TIMEOUT)
        done = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=TIMEOUT)
            done[name] = (p.returncode, out[-3000:] + err[-3000:])
        yield {"dir": d, "gloo": gloo, "done": done}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _ok(runs, name):
    rc, log = runs["done"][name]
    assert rc == 0, log
    return runs["dir"]


def _record(path: Path) -> dict:
    recs = list(path.glob("*.json"))
    assert len(recs) == 1, recs
    return json.loads(recs[0].read_text())


@pytest.fixture(scope="module")
def analytic(runs):
    return json.loads((_ok(runs, "reference") / "reference" / "analytic.json").read_text())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_active_params_equal_reference(analytic, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps

    cfg, want = get_config(arch), analytic[arch]
    assert dryrun.active_param_count(cfg) == want["active_params"] and cfg.param_count() == want["params"]
    assert {n: dryrun.model_flops(cfg, s) for n, s in steps.SHAPES.items()} == want["model_flops"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_probe_cfg_equals_reference(analytic, arch):
    """``_probe_cfg`` field for field the reference's, on every field the
    reference's config has."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    for key, want in analytic[arch]["probe_cfg"].items():
        k, seq, accum = (int(x) for x in key.split(","))
        got = dryrun._probe_cfg(cfg, k, seq, accum)
        for name, value in want.items():
            v = getattr(got, name)
            v = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            assert json.loads(json.dumps(v)) == value, (key, name, v, value)


# the reference record's probe keys with the three-probe fit (its run_cell)
PROBE_KEYS = {"probe_d1", "probe_d2", "probe_d1_a2", "units", "accum", "probe_s"}


@pytest.mark.parametrize("cell", cells.SMALL, ids=lambda c: f"{c[0]}-{c[1]}-{'probe' if c[5] else 'noprobe'}")
def test_small_cell_matches_reference(runs, cell):
    arch, shape, kind, _, _, probe = cell
    got = _record(_ok(runs, "small") / "small" / f"{arch}_{shape}_{kind}{'_probe' if probe else ''}")
    want = _record(_ok(runs, "reference") / "reference" / f"{arch}_{shape}_{kind}")
    assert got["status"] == want["status"] == "ok", got.get("error")
    assert set(want) <= set(got), set(want) - set(got)
    assert set(want["memory"]) <= set(got["memory"])
    for key in ("params", "active_params", "model_flops_total", "kind", "seq", "global_batch", "chips"):
        assert got[key] == want[key], key
    assert got["memory"]["generated_code_bytes"] is None and got["hlo_bytes"] is None
    if probe:
        assert set(got["probe"]) == PROBE_KEYS, got["probe"]
        assert got["flops_per_device"] > 0 and got["scanned_cost"]["flops"] > 0
    else:
        assert "probe_error" in got["probe"]
        assert got["flops_per_device"] == got["scanned_cost"]["flops"]


@pytest.fixture(scope="module")
def counts(runs):
    return json.loads((_ok(runs, "counts") / "counts.json").read_text())


@pytest.mark.parametrize("name", [c[0] for c in cells.GLOO])
def test_fake_counts_equal_gloo_ranks(runs, counts, name):
    """Rank 0 on fake tensors in a fake 4-rank world counts what rank 0 of
    four gloo ranks counts running the same step on real tensors: FLOPs,
    bytes, collective bytes and counts by kind, memory."""
    want = runs["gloo"][0][name]
    got = counts["gloo"][name]
    assert got == want
    assert got["flops"] > 0 and got["collective_bytes"] > 0


def _bilinear(e, i):
    """The cost at (units, accum) from four corner counts, cost = A + a·E +
    d·B + d·a·C."""
    p11, p21, p12 = (e["probe"][k][m] for k in ("probe_d1", "probe_d2", "probe_d1_a2")
                     for m in (("flops", "bytes", "coll")[i],))
    p22 = e["d2_a2"][i]
    c = p22 - p21 - p12 + p11
    b = p21 - p11 - c
    a_e = p12 - p11 - c
    a = p11 - a_e - b - c
    u, m = e["units"], e["accum"]
    return a + m * a_e + u * b + u * m * c


@pytest.mark.parametrize("name", [p[0] for p in cells.PROBES])
def test_probe_fit_equals_direct_count(counts, name):
    e = counts["probes"][name]
    assert e["probe"]["units"] == e["units"] == 3
    if e["accum"] == 1:
        assert e["fit"] == e["direct"], e
        return
    assert e["fit"][0] == e["direct"][0], e  # FLOPs: no term per microbatch outside the layers
    for i in range(3):
        assert _bilinear(e, i) == e["direct"][i], (i, e)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_smoke_cell_on_a_2x2x2_mesh(runs, arch):
    from repro_torch.configs import ALIASES, get_config
    from repro_torch.launch import steps

    d = _ok(runs, "archs0") if arch in HALVES[0] else _ok(runs, "archs1")
    cfg = get_config(arch, smoke=True)
    for shape_name, shape in steps.SHAPES.items():
        rec = json.loads((d / "archs" / f"{ALIASES[arch]}_{shape_name}_multi.json").read_text())
        ok, _ = steps.cell_supported(cfg, steps.smoke_shape(shape))
        assert rec["status"] == ("ok" if ok else "skipped"), (shape_name, rec.get("error"), rec.get("trace"))
        if ok:
            assert rec["chips"] == 8 and rec["flops_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0

"""The port's dry-run cells for ``tests/test_torch_dryrun.py``, run in
processes of their own (a fake process group is process-wide).

As a script, ``python tests/torch_dryrun_cells.py JOB OUT [ARCH ...]``
with ``src`` and ``tests`` on ``PYTHONPATH``:

  * ``small``: the cells of ``tests/test_dryrun_small.py`` (``SMALL``)
    through ``run_cell`` on the CPU, their records under ``OUT``;
  * ``counts``: on a fake (2, 2) world, rank 0's counts of the ``GLOO``
    cells (:func:`gloo_cell`) and the probe cases (``PROBES``: the
    probe's fit from ``run_cell`` beside direct counts of the probe config
    at the cell's depth and at (2 units, ``grad_accum`` 2)), as JSON to
    ``OUT``;
  * ``archs``: every smoke cell of the given archs (all of them by
    default) on a (2, 2, 2) ``pod, data, model`` mesh, no probe, records
    under ``OUT``.

:func:`spawn` runs the ``GLOO`` cells on four ``gloo`` ranks on real
tensors (the same layout, seeded values) and returns each rank's counts
(``tests/torch_sharding_ranks.py``'s spawn).

This module imports neither JAX nor the reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import sys
import traceback

# (arch, shape, mesh kind, mesh shape, axes, with probe) of test_dryrun_small.py
SMALL = (
    ("qwen2-1.5b", "train_4k", "single", (2, 4), ("data", "model"), False),
    ("olmoe-1b-7b", "train_4k", "single", (2, 4), ("data", "model"), False),
    ("rwkv6-3b", "train_4k", "single", (2, 4), ("data", "model"), False),
    ("gemma3-4b", "decode_32k", "multi", (2, 2, 2), ("pod", "data", "model"), False),
    ("qwen2-1.5b", "train_4k", "single", (2, 4), ("data", "model"), True),
)
# (name, arch, shape, overrides) counted on fake tensors and on gloo ranks
GLOO_MESH = (2, 2)
GLOO = (
    ("qwen2_train_accum2", "qwen2-1.5b", "train_4k", {"grad_accum": 2}),
    ("gemma3_decode_pruned", "gemma3-4b", "decode_32k", {}),
    ("gemma3_decode_hier", "gemma3-4b", "decode_32k", {"hier_topk": True}),
)
# (name, arch, shape, overrides) whose probe fit meets direct counts: 3
# cycle units deep
PROBES = (
    ("train_accum1", "qwen2-1.5b", "train_4k", {"num_layers": 3, "grad_accum": 1}),
    ("train_accum2", "qwen2-1.5b", "train_4k", {"num_layers": 3, "grad_accum": 2}),
    ("decode", "qwen2-1.5b", "decode_32k", {"num_layers": 3}),
)
KEYS = ("flops", "bytes accessed", "collective_bytes", "collectives", "collective_counts", "memory")


def _cfg_shape(arch, shape_name, over):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps

    return (dataclasses.replace(get_config(arch, smoke=True), **over),
            steps.smoke_shape(steps.SHAPES[shape_name]))


def _counts(r: dict) -> dict:
    return {k: r[k] for k in KEYS}


def small(out: str) -> None:
    from pathlib import Path

    from repro_torch.launch import dryrun

    for arch, shape, kind, mesh_shape, axes, probe in SMALL:
        dryrun.run_cell(arch, shape, kind, Path(out) / f"{arch}_{shape}_{kind}{'_probe' if probe else ''}", smoke=True,
                        mesh_override=(mesh_shape, axes), with_probe=probe, device="cpu")
    dryrun.stop_world()


def counts(out: str) -> None:
    from pathlib import Path

    from repro_torch.launch import dryrun

    mesh = dryrun.cell_mesh("single", (GLOO_MESH, ("data", "model")), "cpu")
    res = {"gloo": {}, "probes": {}}
    for name, arch, shape_name, over in GLOO:
        cfg, shape = _cfg_shape(arch, shape_name, over)
        res["gloo"][name] = _counts(dryrun.count_cell(cfg, shape, mesh, device="cpu"))
    for name, arch, shape_name, over in PROBES:
        cfg, shape = _cfg_shape(arch, shape_name, over)
        rec = dryrun.run_cell(arch, shape_name, "single", Path(out).parent / f"probe_{name}", smoke=True,
                              mesh_override=(GLOO_MESH, ("data", "model")), cfg_overrides=over, device="cpu",
                              verbose=False)
        units = cfg.num_layers // len(cfg.cycle)
        m = cfg.grad_accum if shape.kind == "train" else 1
        direct = dryrun.count_cell(dryrun._probe_cfg(cfg, units, shape.seq, accum=m), shape, mesh, device="cpu")
        entry = {"fit": [rec["flops_per_device"], rec["bytes_per_device"], rec["collective_bytes_per_device"]],
                 "direct": [direct["flops"], direct["bytes accessed"], direct["collective_bytes"]],
                 "probe": rec["probe"], "units": units, "accum": m}
        if m > 1:  # (2 units, accum 2): the fourth corner of the bilinear cost
            d22 = dryrun.count_cell(dryrun._probe_cfg(cfg, 2, shape.seq, accum=2), shape, mesh, device="cpu")
            entry["d2_a2"] = [d22["flops"], d22["bytes accessed"], d22["collective_bytes"]]
        res["probes"][name] = entry
    dryrun.stop_world()
    Path(out).write_text(json.dumps(res))


def archs(out: str, names) -> None:
    from pathlib import Path

    from repro_torch.configs import ALIASES, ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import SHAPES

    for arch in names or ARCHS:
        for shape in SHAPES:
            dryrun.run_cell(ALIASES.get(arch, arch), shape, "multi", Path(out), smoke=True,
                            mesh_override=((2, 2, 2), ("pod", "data", "model")), with_probe=False, device="cpu",
                            verbose=False)
    dryrun.stop_world()


# ---------------------------------------------------------------- gloo ranks
def gloo_cell(cfg, shape, mesh):
    """The cell's step and arguments as the dry-run lays them out, on real
    tensors: floats N(0, 0.02²), integers drawn below the vocabulary, from
    one seeded generator (the same on every rank)."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun

    g = torch.Generator().manual_seed(0)

    def make(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=g) * 0.02).to(t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=g).to(t.dtype)

    with sharding.set_mesh(mesh):
        return dryrun.cell_step(cfg, shape, mesh, make)


def rank_counts() -> dict:
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    mesh = make_mesh(GLOO_MESH, ("data", "model"), device="cpu")
    out = {}
    for name, arch, shape_name, over in GLOO:
        cfg, shape = _cfg_shape(arch, shape_name, over)
        fn, args = gloo_cell(cfg, shape, mesh)
        with sharding.set_mesh(mesh):
            out[name] = _counts(dryrun.count_step(fn, args))
    return out


def _rank_main(rank: int, world: int, init_file: str, q) -> None:
    try:
        import torch
        import torch.distributed as tdist

        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=120))
        try:
            q.put((rank, "ok", rank_counts()))
        finally:
            tdist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def spawn(workdir: str, timeout: float = 300.0) -> list:
    """:func:`rank_counts` on four gloo ranks, their results in rank order."""
    import torch_sharding_ranks

    return torch_sharding_ranks.spawn(4, workdir, timeout, main=_rank_main)


if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)
    job, out, names = sys.argv[1], sys.argv[2], sys.argv[3:]
    if job == "small":
        small(out)
    elif job == "counts":
        counts(out)
    elif job == "archs":
        archs(out, names)
    else:
        raise SystemExit(f"unknown job {job!r}")

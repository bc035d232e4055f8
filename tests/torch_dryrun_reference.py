"""The reference's dry-run cells of ``tests/test_dryrun_small.py`` for
``tests/test_torch_dryrun.py`` to hold the port's records against.

Run as a script, ``python tests/torch_dryrun_reference.py OUTDIR``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set and ``src`` and
``tests`` on ``PYTHONPATH``: ``repro.launch.dryrun.run_cell`` on each cell
of ``torch_dryrun_cells.SMALL`` without its probe, its record under
``OUTDIR/<cell>``, and the analytic functions' values in
``OUTDIR/analytic.json`` (:func:`analytic`). The
reference's ``make_mesh`` builds its meshes with JAX's default
``Explicit`` axis types, under which these cells fail
(``tests/test_dryrun_small.py``); here it is replaced, in this process
only, by one that builds ``Auto`` axes. No file of the reference changes.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
from jax.sharding import AxisType

import repro.launch.dryrun as dryrun
from torch_dryrun_cells import SMALL


def auto_mesh(shape, axes):
    return jax.make_mesh(tuple(shape), tuple(axes), axis_types=(AxisType.Auto,) * len(axes))


def analytic() -> dict:
    """``model_flops`` and ``active_param_count`` of every full config at
    every shape, and ``_probe_cfg``'s fields at k 1 and 2, ``accum`` 1 and
    2 and the shapes' lengths."""
    from repro.configs import ALIASES, get_config
    from repro.launch import steps

    out = {}
    for arch in ALIASES:
        cfg = get_config(arch)
        out[arch] = {"active_params": dryrun.active_param_count(cfg), "params": cfg.param_count(),
                     "model_flops": {n: dryrun.model_flops(cfg, s) for n, s in steps.SHAPES.items()},
                     "probe_cfg": {f"{k},{seq},{accum}": _fields(dryrun._probe_cfg(cfg, k, seq, accum))
                                   for k in (1, 2) for seq in (4096, 32768) for accum in (1, 2)}}
    return out


def _fields(cfg) -> dict:
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg) for v in (getattr(cfg, f.name),)}


def main(outdir: str) -> None:
    dryrun.make_mesh = auto_mesh
    Path(outdir).mkdir(parents=True, exist_ok=True)
    (Path(outdir) / "analytic.json").write_text(json.dumps(analytic()))
    # each cell once, without the probe's compiles (its record's keys are the same)
    for arch, shape, kind, mesh_shape, axes in dict.fromkeys(cell[:5] for cell in SMALL):
        dryrun.run_cell(arch, shape, kind, Path(outdir) / f"{arch}_{shape}_{kind}", smoke=True,
                        mesh_override=(mesh_shape, axes), with_probe=False, verbose=False)


if __name__ == "__main__":
    main(sys.argv[1])

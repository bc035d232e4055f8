"""Multi-pod dry-run (the reference's ``repro/launch/dryrun.py``): for every
(architecture × input shape × mesh) cell, run the step function on fake
tensors in a fake world and record what one device would hold, compute,
move and communicate, as JSON records ``benchmarks/roofline.py`` reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape decode_32k --smoke --mesh-shape 2,2,2 \\
        --mesh-axes pod,data,model --device cpu --no-probe

The world. The dry-run starts the ``"fake"`` process group itself
(``torch.testing._internal.distributed.fake_pg``), as rank 0 of the mesh's
size: 256 ranks for ``single``, 512 for ``multi``, or the product of
``--mesh-shape``; between meshes of different sizes (``--mesh both``) it
tears the group down and starts it again. Every collective returns at
once, without data. The mesh is the port's ``make_mesh`` /
``make_production_mesh`` on ``--device`` (``cuda``, the default, or
``cpu``; ``cuda`` needs a card).

The cell. Parameters, optimizer state, inputs and the decode cache are
fake tensors (``FakeTensorMode``: shapes, dtypes and a device, no memory)
at the spec shapes of ``launch/steps.py``, placed as the reference's
cells place them (``params_shardings``, ``data_shardings``,
``cache_shardings``, the ``long_500k`` rule); the step is the port's own
(``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``) and
runs eagerly, rank 0's part of it. A decode cell decodes one token at the
last position of a full cache (``pos = seq - 1``, a Python int), over a
cache made by ``cache_specs`` and placed, not by a prefill. On fake CUDA
tensors the kernel wrappers launch nothing: they return empty outputs and
report their bound's FLOPs and bytes (``kernels.common.fake_launch``); on
fake CPU tensors the plain versions run, as on real ones. A step that
branches on a value it received (``.item()``, an owner found from data)
cannot run on fake tensors: its cell ends ``error`` with the reason.

What is counted, per device (rank 0):

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the step,
    plus the FLOPs the fake kernels report;
  * ``bytes accessed``: the bytes of the local tensor inputs and outputs of
    every operation that is not a view (this eager port's own traffic),
    plus the fake kernels' bytes;
  * collective bytes by the reference's five kinds, from the c10d and
    functional collectives the step issues (each op's result bytes; a ring
    all-reduce counts twice in the total, as the reference's
    ``collective_bytes`` does; its CPU "promoted" halving has no
    counterpart), and their counts;
  * memory: ``argument_bytes`` (the step's local inputs), ``output_bytes``
    (its local outputs), ``temp_bytes`` (the peak of the storages the step
    allocated and had alive at once: peak live minus arguments, from a
    live-storage tracker) and ``alias_bytes`` (inputs the step wrote in
    place: a decode's cache; 0 for the train step, which writes to none of
    its inputs). ``generated_code_bytes`` and ``hlo_bytes`` have no
    counterpart and are ``null``. With uneven splits rank 0 holds the
    largest chunk, so its memory is the most any rank holds.

The probe. The reference compiles unrolled shallow copies of a cell at 1
and 2 cycle units (and at ``grad_accum`` 2) because XLA counts a ``while``
body once, and extrapolates. The port's loops are Python loops, so the
full-depth count (``scanned_cost``) is exact; with the probe on (the
default) the same probe configs (``_probe_cfg``) are counted and fitted
as the reference fits them (``run_cell``), and the fit gives
``flops_per_device``, ``bytes_per_device`` and
``collective_bytes_per_device``.

The constants are the H100's (SXM, dense, 700 W; NVIDIA's data sheet):
``PEAK_FLOPS`` 989e12 (bf16), ``HBM_BW`` 3.35e12 B/s, and NVLink 4's 450e9
B/s each way (900 GB/s both ways) for collectives. A 256-card mesh spans 32
eight-card nodes, whose links between nodes are slower than NVLink, so
``t_collective`` at NVLink's rate is a lower bound.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.probe import probe_mode
from repro_torch.kernels import common as kernel_common
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh, make_production_mesh

# H100 SXM constants (per card; NVIDIA's data sheet, dense, 700 W)
PEAK_FLOPS = 989e12  # bf16
HBM_BW = 3.35e12  # B/s
ICI_BW = 450e9  # B/s, NVLink 4 each way (the reference's name)

_COLLS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the c10d and functional collectives a step can issue (the port's own
# calls and DTensor's redistributions), by op name -> the reference's kinds
_COLL_KIND = {
    **dict.fromkeys(("all_gather_into_tensor", "allgather_", "_allgather_base_"), "all-gather"),
    **dict.fromkeys(("all_reduce", "allreduce_"), "all-reduce"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_", "_reduce_scatter_base_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_base_"), "all-to-all"),
    **dict.fromkeys(("send", "recv_"), "collective-permute"),
}


_DEVICE = torch.ops.prim.device.default
# identities of the functional collectives: a wait, and the autograd wrapper
# a real (not fake) result passes through
_NO_TRAFFIC = ("wait_tensor", "_wrap_tensor_autograd")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if type(t).__name__ == "DTensor" else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's arguments or result (nested tuples, lists,
    dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        if all(isinstance(t, torch.Tensor) for t in tree):
            return list(tree)
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class Counter(TorchDispatchMode):
    """The dry-run's counts of one step, made as it runs (any tensors,
    fake or real): bytes of every non-view operation's local inputs and
    outputs, collectives by kind (result bytes, counts), the storages the
    step allocated (live now, peak), and the launches the kernel wrappers
    stood in for on fake tensors (``kernels.common.fake_launch``)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.bytes = 0
        self.coll = {k: 0 for k in _COLLS}
        self.coll_counts = {k: 0 for k in _COLLS}
        self.kernel_flops = 0
        self.kernel_calls: list = []
        self.live = self.peak = 0
        self._seen: dict = {}
        args = {}
        for t in _tensors(arguments):
            t = _local(t)
            args[(t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape))] = t
        self._arg_storages = {k[0] for k in args}
        self.arguments = list(args.values())
        self.argument_bytes = sum(_nbytes(t) for t in self.arguments)
        self._versions = [t._version for t in self.arguments]

    def _kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.kernel_flops += flops
        self.bytes += nbytes
        self.kernel_calls.append([name, flops, nbytes])

    def __enter__(self):
        kernel_common.COST_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_common.COST_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        if type(t).__name__ == "DTensor":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen or key in self._arg_storages:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)

        self._seen[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:  # a fake tensor's ``.device``, asked for by the autograd engine
            return out
        name = func._schema.name.split("::")[-1]
        kind = _COLL_KIND.get(name) if func.namespace in ("c10d", "_c10d_functional") else None
        outs = _tensors(out)
        if kind is not None:
            res = outs or _tensors(args[:1])
            self.coll[kind] += sum(_nbytes(t) for t in res)
            self.coll_counts[kind] += 1
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(_local(t))
        return out

    def alias_bytes(self) -> int:
        """Bytes of the arguments the step wrote in place."""
        return sum(_nbytes(t) for t, v in zip(self.arguments, self._versions) if t._version != v)


def collective_total(by_kind: dict) -> int:
    """The reference's modelled link traffic: a ring all-reduce moves ~2×
    its buffer, the others ~1×."""
    return sum(v * (2 if k == "all-reduce" else 1) for k, v in by_kind.items())


def model_flops(cfg, shape: steps_lib.ShapeSpec) -> float:
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq
    return 2.0 * n_active * shape.global_batch  # decode: one token per row


def active_param_count(cfg) -> int:
    """Params touched per token (MoE: top-k experts instead of all)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = cfg._mlp_params(m.expert_d_ff, cfg.d_model)
    n_moe_layers = sum(1 for k in cfg.pattern() if k == "M")
    inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
    return total - inactive


def _probe_cfg(cfg, k: int, seq: int = 4096, accum: int = 1):
    """The reference's probe config: ``cfg`` k cycle units deep (an
    encoder in proportion), ``scan_layers`` off, ``accum`` microbatches,
    flash chunks of 4096 and RWKV chunks of at least seq / 64."""
    c = len(cfg.cycle)
    n = k * c
    enc = 0
    if cfg.enc_layers:
        enc = max(1, round(cfg.enc_layers * n / cfg.num_layers))
    return dataclasses.replace(
        cfg, num_layers=n, enc_layers=enc, scan_layers=False, grad_accum=accum,
        attn_chunk_q=4096, attn_chunk_kv=4096,
        rwkv_chunk=max(cfg.rwkv_chunk, seq // 64),
    )


# ---------------------------------------------------------------- the world
_WORLD: dict = {"size": None, "meshes": {}}


def start_world(size: int) -> None:
    """The fake process group of ``size`` ranks, this process rank 0; an
    existing group of another size (or backend) is torn down first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if _WORLD["size"] == size:
            return
        stop_world()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    _WORLD["size"] = size


def stop_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD["size"] = None
    _WORLD["meshes"].clear()


def cell_mesh(mesh_kind: str, mesh_override, device: str):
    """The cell's mesh over a fake world of its size (built once a world)."""
    if mesh_override is not None:
        shape, axes = mesh_override
        size = math.prod(shape)
    else:
        shape, axes, size = None, None, 512 if mesh_kind == "multi" else 256
    start_world(size)
    key = (mesh_kind if mesh_override is None else (tuple(shape), tuple(axes)), device)
    if key not in _WORLD["meshes"]:
        _WORLD["meshes"][key] = (make_mesh(shape, axes, device) if mesh_override is not None
                                 else make_production_mesh(multi_pod=mesh_kind == "multi", device=device))
    return _WORLD["meshes"][key]


# ---------------------------------------------------------------- counting
def _fake(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def cell_step(cfg, shape, mesh, make):
    """(step, its arguments) of ``shape``'s kind, laid out on ``mesh`` as
    ``run_cell`` lays the cell out: every tensor ``make(spec)`` (a tensor
    like the ``meta`` spec), placed by the reference's shardings; a decode
    at ``pos = shape.seq - 1``. The mesh must be ambient."""
    made = lambda tree: {k: make(v) for k, v in tree.items()}  # noqa: E731
    params = made(steps_lib.state_specs(cfg, with_opt=False)[0])
    if shape.kind == "train":
        opt_state = steps_lib.make_optimizer(cfg).init(params)
        p_sh, o_sh = steps_lib.params_shardings(cfg, mesh, params, opt_state)
        args = (steps_lib.place_tree(params, p_sh), steps_lib.place_tree(opt_state, o_sh),
                made(steps_lib.input_specs(cfg, shape)))
        return steps_lib.make_train_step(cfg, grad_shardings=p_sh), args
    p_sh, _ = steps_lib.params_shardings(cfg, mesh, params)
    placed = steps_lib.place_tree(params, p_sh)
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(cfg, shape), (placed, made(steps_lib.input_specs(cfg, shape)))
    d = steps_lib.input_specs(cfg, shape)
    d_sh = steps_lib.data_shardings(cfg, shape, mesh)
    cache = sharding._map_cache(make, steps_lib.cache_specs(cfg, shape))
    cache = steps_lib.place_tree(cache, steps_lib.cache_shardings(cfg, shape, mesh, cache))
    token = sharding.place(make(d["token"]), d_sh["token"])
    return steps_lib.make_decode_step(cfg), (placed, token, shape.seq - 1, cache)


def count_step(fn, args) -> dict:
    """``fn(*args)`` run once under the counters (fake tensors or real)
    -> ``{"flops", "bytes accessed", "collective_bytes", "collectives",
    "collective_counts", "memory", "kernel_calls", "run_s"}``, this rank's."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    with FlopCounterMode(display=False) as flops, Counter(args) as c:
        out = fn(*args)
    run_s = time.time() - t0
    outs = {}
    for t in _tensors(out):
        t = _local(t)
        outs[(t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape))] = t
    mem = {"argument_bytes": c.argument_bytes, "output_bytes": sum(_nbytes(t) for t in outs.values()),
           "temp_bytes": c.peak, "generated_code_bytes": None, "alias_bytes": c.alias_bytes(),
           "peak_bytes": c.argument_bytes + c.peak}
    return {
        "flops": float(flops.get_total_flops() + c.kernel_flops),
        "bytes accessed": float(c.bytes),
        "collective_bytes": float(collective_total(c.coll)),
        "collectives": dict(c.coll),
        "collective_counts": dict(c.coll_counts),
        "memory": mem,
        "kernel_calls": c.kernel_calls,
        "run_s": run_s,
    }


def count_cell(cfg, shape, mesh, rules=None, device="cuda") -> dict:
    """The cell's step run once on fake tensors on ``device`` under the
    counters (:func:`count_step`), rank 0's, per device; ``lower_s`` the
    seconds spent making and placing the fake state."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with sharding.set_mesh(mesh), sharding.axis_rules(rules or {}), FakeTensorMode():
        fn, args = cell_step(cfg, shape, mesh, lambda t: _fake(t, device))
        lower_s = time.time() - t0
        out = count_step(fn, args)
    return dict(out, lower_s=lower_s)


def _probe_costs(cfg, shape, mesh, rules, device):
    """A probe config's (flops, bytes, collective bytes) per device."""
    with probe_mode():
        r = count_cell(cfg, shape, mesh, rules, device)
    return r["flops"], r["bytes accessed"], r["collective_bytes"]


def _launches() -> dict:
    """The LM kernels' launch counters (fake tensors never tick them)."""
    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.kernels.topk_select import ops as ts

    return {**{f"topk_decode_attention.{k}": v for k, v in tda.LAUNCHES.items()},
            **{f"topk_select.{k}": v for k, v in ts.LAUNCHES.items()}}


def _mem_repr(mem: dict) -> str:
    return ", ".join(f"{k}={mem[k]}" for k in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                                 "peak_bytes"))


def _parse_val(v: str):
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    if v in ("none", "None"):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    out_dir: Path,
    smoke: bool = False,
    mesh_override=None,
    ade_on: bool = True,
    verbose: bool = True,
    with_probe: bool = True,
    cfg_overrides: dict | None = None,
    tag_suffix: str = "",
    rules_override: dict | None = None,
    device: str = "cuda",
):
    """The reference's ``run_cell``: the cell's record, written to
    ``out_dir`` (see the module docstring for what each field counts).
    ``lower_s`` is the seconds spent making and placing the fake state,
    ``compile_s`` the seconds the step ran (there is no compiler), and
    ``cell_s`` the cell's seconds in all, probes included."""
    t_cell = time.time()
    cfg = get_config(arch, smoke=smoke)
    if not ade_on and cfg.attn_prune_k is not None:
        cfg = dataclasses.replace(cfg, attn_prune_k=None)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = steps_lib.SHAPES[shape_name]
    if smoke:
        shape = steps_lib.smoke_shape(shape)
    ok, why = steps_lib.cell_supported(cfg, shape)
    rec = {
        "arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "seq": shape.seq, "global_batch": shape.global_batch,
        "params": cfg.param_count(), "active_params": active_param_count(cfg),
        "overrides": {k: str(v) for k, v in (cfg_overrides or {}).items()},
    }
    tag = f"{arch}_{shape_name}_{mesh_kind}{tag_suffix}"
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_dir, tag, rec, verbose)
        return rec

    rules = {}
    if shape.name == "long_500k":
        # batch=1: nothing for the data axes to do on activations — spread
        # the KV/cache sequence over every axis instead.
        rules = {"cache_seq": ("pod", "data", "model")}
    if rules_override:
        rules.update(rules_override)

    launched = _launches()
    try:
        mesh = cell_mesh(mesh_kind, mesh_override, device)
        rec["chips"] = int(mesh.size())
        cost = count_cell(cfg, shape, mesh, rules, device)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:], cell_s=round(time.time() - t_cell, 2))
        _write(out_dir, tag, rec, verbose)
        return rec
    n_chips = rec["chips"]
    flops, bytes_acc, coll_total = cost["flops"], cost["bytes accessed"], cost["collective_bytes"]

    # the reference's probe: shallow copies at 1 and 2 cycle units (and at
    # grad_accum 2), fitted linearly to the real depth
    probe = {}
    t0p = time.time()
    try:
        if not with_probe:
            raise RuntimeError("probe disabled (multi-pod pass is proof-only)")
        p1 = _probe_costs(_probe_cfg(cfg, 1, shape.seq), shape, mesh, rules, device)
        p2 = _probe_costs(_probe_cfg(cfg, 2, shape.seq), shape, mesh, rules, device)
        units = cfg.num_layers / len(cfg.cycle)
        m = cfg.grad_accum if shape.kind == "train" else 1
        if m > 1 and shape.global_batch % 2 == 0:
            p3 = _probe_costs(_probe_cfg(cfg, 1, shape.seq, accum=2), shape, mesh, rules, device)

            def fit(i):
                C = max(0.0, p3[i] - p1[i])
                B = max(0.0, p2[i] - p1[i] - C)
                A = max(0.0, p1[i] - B - C)
                return A + units * B + units * m * C
            flops, bytes_acc, coll_total = fit(0), fit(1), fit(2)
            probe_extra = {"probe_d1_a2": {"flops": p3[0], "bytes": p3[1], "coll": p3[2]}}
        else:
            flops = p1[0] + (p2[0] - p1[0]) * (units - 1)
            bytes_acc = p1[1] + (p2[1] - p1[1]) * (units - 1)
            coll_total = p1[2] + (p2[2] - p1[2]) * (units - 1)
            probe_extra = {}
        probe = {
            "probe_d1": {"flops": p1[0], "bytes": p1[1], "coll": p1[2]},
            "probe_d2": {"flops": p2[0], "bytes": p2[1], "coll": p2[2]},
            **probe_extra,
            "units": units,
            "accum": m,
            "probe_s": round(time.time() - t0p, 2),
        }
    except Exception as e:
        probe = {"probe_error": f"{type(e).__name__}: {e}"}
    t_comp = flops / PEAK_FLOPS
    t_mem = bytes_acc / HBM_BW
    t_coll = coll_total / ICI_BW
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll), key=lambda kv: kv[1])[0]
    mflops = model_flops(cfg, shape)
    mem = dict(cost["memory"], repr=_mem_repr(cost["memory"]))
    rec.update(
        status="ok",
        lower_s=round(cost["lower_s"], 2),
        compile_s=round(cost["run_s"], 2),
        probe=probe,
        scanned_cost={"flops": cost["flops"], "bytes accessed": cost["bytes accessed"]},
        flops_per_device=flops,
        bytes_per_device=bytes_acc,
        collective_bytes_per_device=coll_total,
        collectives=cost["collectives"],
        collective_counts=cost["collective_counts"],
        memory=mem,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        dominant=dom,
        model_flops_total=mflops,
        model_flops_per_device=mflops / n_chips,
        useful_flops_ratio=(mflops / n_chips) / flops if flops else None,
        roofline_fraction=(mflops / n_chips / PEAK_FLOPS) / max(t_comp, t_mem, t_coll)
        if max(t_comp, t_mem, t_coll) > 0 else None,
        hlo_bytes=None,
        kernel_calls=cost["kernel_calls"],
        kernel_launches={k: v - launched[k] for k, v in _launches().items()},
        device=device,
        cell_s=round(time.time() - t_cell, 2),
    )
    _write(out_dir, tag, rec, verbose)
    return rec


def _write(out_dir: Path, tag: str, rec, verbose: bool):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    if verbose:
        if rec["status"] == "ok":
            print(
                f"[dryrun] {tag}: OK lower={rec['lower_s']}s compile={rec['compile_s']}s "
                f"flops/dev={rec['flops_per_device']:.3e} bytes/dev={rec['bytes_per_device']:.3e} "
                f"coll/dev={rec['collective_bytes_per_device']:.3e} dominant={rec['dominant']} "
                f"roofline_frac={rec['roofline_fraction'] and round(rec['roofline_fraction'],4)} "
                f"cell={rec['cell_s']}s",
                flush=True,
            )
            print(f"[dryrun] {tag} memory: {rec['memory'].get('repr')}", flush=True)
        else:
            print(f"[dryrun] {tag}: {rec['status']} {rec.get('reason', rec.get('error',''))}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(steps_lib.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--smoke", action="store_true", help="reduced configs/shapes")
    ap.add_argument("--mesh-shape", default=None, help="e.g. 2,4 (test meshes)")
    ap.add_argument("--mesh-axes", default=None, help="e.g. data,model")
    ap.add_argument("--no-ade", action="store_true", help="disable attn pruning")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip cost probes (full-depth count only)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb runs)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding rule override name=ax1+ax2 (hillclimb)")
    ap.add_argument("--tag", default="", help="output filename suffix")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors and the mesh are on (cuda: the card's path)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: --device cuda needs a CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to dry-run the CPU path")
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_val(v)
    rules_ov = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rules_ov[k] = tuple(a for a in v.split("+") if a)

    archs = list(ARCHS) if args.arch == "all" else [ALIASES.get(args.arch, args.arch)]
    shapes = list(steps_lib.SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    override = None
    if args.mesh_shape:
        override = (
            tuple(int(x) for x in args.mesh_shape.split(",")),
            tuple(args.mesh_axes.split(",")),
        )
    out_dir = Path(args.out)
    n_ok = n_bad = 0
    with contextlib.ExitStack() as stack:
        stack.callback(stop_world)
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    rec = run_cell(
                        arch, shape, mesh_kind, out_dir,
                        smoke=args.smoke, mesh_override=override,
                        ade_on=not args.no_ade,
                        with_probe=not args.no_probe,
                        cfg_overrides=overrides or None,
                        tag_suffix=args.tag,
                        rules_override=rules_ov or None,
                        device=args.device,
                    )
                    if rec["status"] == "error":
                        n_bad += 1
                    else:
                        n_ok += 1
    print(f"[dryrun] done: {n_ok} ok/skipped, {n_bad} errors", flush=True)
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()

"""The reference run sharded on the mesh that ``tests/torch_lm_mesh_ranks.py``
runs the port on, for ``tests/test_torch_lm_mesh.py`` to hold the two
against each other.

Run as a script: ``python tests/torch_lm_mesh_reference.py OUTDIR``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (or more) set, so
that JAX's CPU backend has the mesh's devices, and ``src`` and ``tests`` on
``PYTHONPATH``. On a ``jax.make_mesh`` of ``REFERENCE_MESH`` over ``("data",
"model")`` with ``Auto`` axes, under ``jax.set_mesh``:

  * ``REFERENCE_TRAIN``: one step of the reference's
    ``make_train_step(cfg, grad_shardings=)``, jitted with
    ``params_shardings`` / ``data_shardings`` in and out (as its dry-run
    lays a train step out), from the port's seeded parameters laid out in
    the reference's tree (the ranks' ``redrawn_params``), on the ranks'
    batch: the loss, parameters and AdamW moments written, as the port's
    names, to ``OUTDIR/ref_train_<arch>.npz``;
  * ``REFERENCE_DECODE``: the reference's prefill and decode steps
    (``make_prefill_step`` / ``make_decode_step``) with caches placed by
    ``cache_shardings``, teacher-forced on the ranks' tokens: each step's
    logits to ``OUTDIR/ref_<name>`` (``hier_topk`` runs its shard-local
    pass over the ``model`` axis here).

Each program is compiled with XLA's cheap CPU options, as
``tests/torch_lm_parity.py`` compiles the reference's.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_config as tget

import torch_lm_mesh_ranks as ranks

CHEAP_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _key(kp) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def reference_tree(jcfg, tcfg):
    """The ranks' ``redrawn_params(tcfg)`` laid out in the reference's
    parameter tree (numpy leaves)."""
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    port = {n: p.detach().float().numpy() for n, p in ranks.redrawn_params(tcfg).items()}
    flat = {_key(kp): np.zeros(leaf.shape, leaf.dtype) for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for name, path, r in convert.lm_layout(tcfg, shapes):
        flat[path][... if r is None else r] = port[name]
    return jax.tree_util.tree_map_with_path(lambda kp, _: flat[_key(kp)], shapes)


def compiled(fn, in_shardings, out_shardings, *args):
    return jax.jit(fn, in_shardings=in_shardings, out_shardings=out_shardings).lower(*args).compile(
        compiler_options=CHEAP_COMPILE)


def train(arch, fsdp, mesh, outdir):
    over = dict(grad_accum=2, fsdp=fsdp)
    jcfg, tcfg = (dataclasses.replace(get(arch, smoke=True), **over) for get in (jget, tget))
    tree = reference_tree(jcfg, tcfg)
    batch = {k: v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy()
             for k, v in ranks.batch(tcfg).items()}
    shape = jsteps.ShapeSpec("mesh", "train", ranks.SEQ, ranks.BATCH)
    opt = jsteps.make_optimizer(jcfg)
    p_sh, o_sh = jsteps.params_shardings(jcfg, mesh, *jsteps.state_specs(jcfg, with_opt=True))
    d_sh = jsteps.data_shardings(jcfg, shape, mesh)
    params = jax.device_put(tree, p_sh)
    state = jax.device_put(opt.init(jax.tree.map(jnp.asarray, tree)), o_sh)
    data = jax.device_put(batch, d_sh)
    step = compiled(jsteps.make_train_step(jcfg, grad_shardings=p_sh), (p_sh, o_sh, d_sh), (p_sh, o_sh, None),
                    params, state, data)
    new_p, new_s, loss = step(params, state, data)
    whole = convert.lm_params_from_reference(tcfg, jax.tree.map(np.asarray, new_p), device="cpu")
    moments = convert.opt_state_from_reference(tcfg, jax.tree.map(np.asarray, new_s), device="cpu")
    out = {"loss": np.asarray(loss, np.float32).reshape(1)}
    out.update({f"params.{n}": t.float().numpy() for n, t in whole.items()})
    for part in ("mu", "nu"):
        out.update({f"opt.{part}.{n}": t.float().numpy() for n, t in getattr(moments, part).items()})
    np.savez(os.path.join(outdir, f"ref_train_{arch}.npz"), **out)


def decode(arch, over, mesh, outdir):
    jcfg, tcfg = (dataclasses.replace(get(arch, smoke=True), **over) for get in (jget, tget))
    tree = reference_tree(jcfg, tcfg)
    prompt, toks = ranks.decode_tokens(tcfg)
    pshape = jsteps.ShapeSpec("mesh", "prefill", ranks.MAX_LEN, ranks.BATCH)
    dshape = jsteps.ShapeSpec("mesh", "decode", ranks.MAX_LEN, ranks.BATCH)
    p_sh, _ = jsteps.params_shardings(jcfg, mesh, jsteps.state_specs(jcfg, with_opt=False)[0])
    in_sh = jsteps.data_shardings(jcfg, pshape, mesh)
    tok_sh = jsteps.data_shardings(jcfg, dshape, mesh)
    params = jax.device_put(tree, p_sh)
    batch = jax.device_put({"tokens": prompt}, in_sh)
    prefill_fn = jsteps.make_prefill_step(jcfg, pshape)
    cache_s = jax.eval_shape(lambda p, b: prefill_fn(p, b)[1], params, batch)
    c_sh = jsteps.cache_shardings(jcfg, dshape, mesh, cache_s)
    prefill = compiled(prefill_fn, (p_sh, in_sh), (None, c_sh), params, batch)
    logits, cache = prefill(params, batch)
    out = {"logits_0": np.asarray(logits, np.float32)}
    step_fn = jsteps.make_decode_step(jcfg)
    token = jax.device_put(toks[0], tok_sh["token"])
    pos = jax.device_put(np.int32(ranks.PROMPT), tok_sh["pos"])
    step = compiled(step_fn, (p_sh, tok_sh["token"], tok_sh["pos"], c_sh), (None, c_sh), params, token, pos, cache)
    for i in range(ranks.GEN):
        token = jax.device_put(toks[i], tok_sh["token"])
        pos = jax.device_put(np.int32(ranks.PROMPT + i), tok_sh["pos"])
        logits, cache = step(params, token, pos, cache)
        out[f"logits_{i + 1}"] = np.asarray(logits, np.float32)
    np.savez(os.path.join(outdir, "ref_" + ranks.reference_decode_name(arch, over)[len("port_"):]), **out)


def main(outdir: str) -> None:
    torch.set_num_threads(1)
    shape = ranks.REFERENCE_MESH
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])
    with jsh.set_mesh(mesh):
        for arch, fsdp in ranks.REFERENCE_TRAIN:
            train(arch, fsdp, mesh, outdir)
        for arch, over in ranks.REFERENCE_DECODE:
            decode(arch, over, mesh, outdir)


if __name__ == "__main__":
    main(sys.argv[1])

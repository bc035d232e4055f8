"""Shared parity helpers of ``tests/test_torch_lm_train*.py``: the smoke
configs of both packages, the reference's parameters (the port's seeded
init in the reference's tree, cached per arch, with biases, norm scales
and biases, cross gates, experts and routers redrawn so that each moves
the loss: both packages init biases and gates at zero), seeded batches,
and the per-arch checks of ``LM.forward_train`` / ``LM.loss_fn`` and
``remat``."""
import dataclasses
import functools
import gc
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models.lm import LM, build_model

ATOL = 1e-5

# XLA's cheap CPU compile: the reference's smoke programs compile in about
# half the time, with the same operations (fusion may round differently, by
# ~1e-6 of a gradient's magnitude)
CHEAP_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit(fn):
    """``jax.jit(fn)`` compiled with :data:`CHEAP_COMPILE` at its first
    call's shapes (one program: call it with those shapes only)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(compiler_options=CHEAP_COMPILE))
        return compiled[0](*args)

    return call


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The smoke models' steps are thousands of tiny operators: one
    intra-op thread runs them about twice as fast as eight alone, and keeps
    them from spinning against the other test workers on the same cores
    (a trainer test ran 20× slower in a full parallel run without it).
    Imported by each ``test_torch_lm_train*.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def end_leaked_serve_threads():
    """The reference's ``test_serve_faults.py`` closes threaded front-ends
    whose drain it poisoned for good; their threads then spin for the rest
    of the process, slowing whatever file this worker runs next (ROADMAP,
    "Faults found"). Lift the poison from such closed front-ends so their
    loops drain and return. Imported by each ``test_torch_lm_train*.py``."""
    frontend = sys.modules.get("repro.serve.frontend")
    if frontend is not None:
        for fe in [o for o in gc.get_objects() if type(o) is frontend.ServeFrontend]:
            h = fe.health()
            if h.closed and (h.collector_alive or h.stepper_alive):
                fe.faults = None
                fe.queue.notify_all()
                fe.executor.join(5.0)


def cfgs(arch, **over):
    """The smoke config of ``arch`` in both packages, with ``over`` and
    flash chunks of 16: a 24-token batch runs 2 query chunks over 2 KV
    chunks (the masked-block paths of the flash loops), and far fewer
    masked logits reach ``exp`` than in one 128-row chunk, whose masked
    entries take a slow path on the CPU."""
    over = {"attn_chunk_q": 16, "attn_chunk_kv": 16, **over}
    return dataclasses.replace(jget(arch, smoke=True), **over), dataclasses.replace(tget(arch, smoke=True), **over)


def _redraw(tree, rng, path=()):
    """The reference's numpy tree with biases, norm scales and biases, cross
    gates, experts and the router redrawn (see the module docstring)."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw(v, rng, path + (i,)) for i, v in enumerate(tree))
    name = path[-1]
    if name in ("bq", "bk", "bv", "scale", "bias", "gate"):
        return (rng.normal(size=tree.shape) * (1.0 if name == "gate" else 0.3)).astype(np.float32)
    if "experts" in path:
        return (rng.normal(size=tree.shape) * tree.shape[-2] ** -0.5).astype(np.float32)
    if "router" in path:
        return (rng.normal(size=tree.shape) * 2.4 * tree.shape[-2] ** -0.5).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _tree(jcfg, tcfg, seed):
    from repro.models import build_model as jbuild

    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(seed))
    lm = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    port = {n: p.detach().float().numpy() for n, p in lm.named_parameters()}
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        flat[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)] = np.zeros(leaf.shape, leaf.dtype)
    for name, path, r in convert.lm_layout(tcfg, shapes):
        flat[path][... if r is None else r] = port[name]
    tree = jax.tree_util.tree_map_with_path(
        lambda kp, _: flat[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)], shapes)
    return _redraw(tree, np.random.default_rng(seed))


def reference(jcfg, tcfg, seed=0):
    """The reference's model and its parameter tree (numpy leaves,
    read-only: one tree per config and seed, shared): the port's seeded
    init (``reset_parameters``, which follows the reference's init rules)
    laid out as the reference's init's shapes, traced and not compiled
    (compiling its random init took 0.6-1.5 s an arch), then redrawn."""
    from repro.models import build_model as jbuild

    same = {"optimizer": "adamw", "grad_accum": 4}  # neither moves the init
    return jbuild(jcfg), _tree(dataclasses.replace(jcfg, **same), dataclasses.replace(tcfg, **same), seed)


def make_batch(cfg, b=2, s=24, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    n = cfg.num_img_tokens or cfg.num_audio_frames
    if n:
        out["context"] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_leaves(got, want, rel, what):
    """Each leaf within ``rel`` of its largest magnitude in ``want``."""
    assert set(got) == set(want), what
    for name, w in want.items():
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
        g = got[name].float().numpy()
        tol = rel * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what} {name}")


def check_forward_train(arch):
    """Logits (1e-5), aux, the loss (1e-5) and every gradient leaf (1e-4 of
    its largest magnitude) against the reference's ``forward_train`` and
    ``jax.value_and_grad(loss_fn)``; a redrawn parameter of each kind moves
    the loss."""
    jcfg, tcfg = cfgs(arch)
    jm, tree = reference(jcfg, tcfg)
    params = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    batch = make_batch(tcfg)

    def both(tree, batch):  # one program for the forward and the loss's gradient
        return jm.forward_train(tree, batch["tokens"], batch.get("context")), jax.value_and_grad(jm.loss_fn)(tree, batch)

    (jl, jaux), (jloss, jgrads) = jit(both)(tree, as_jax(batch))
    lm = LM(tcfg, device="meta")
    leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
    tl, taux = lm.forward_train(leaves, torch.from_numpy(batch["tokens"]),
                                None if "context" not in batch else torch.from_numpy(batch["context"]))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), atol=ATOL, rtol=0)
    if tcfg.moe is not None:
        assert float(taux) > 0.1  # the aux loss is in the loss
    loss = lm.loss_fn(leaves, as_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = convert.lm_params_from_reference(tcfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    # a cross-attention's key bias adds q·bk to every logit of a query's row,
    # which the softmax cancels: its gradient is zero but for rounding, in
    # both packages, so it is held to that instead of to its own noise
    scale = max(float(w.abs().max()) for w in want.values())
    for n in [n for n in want if n.endswith("cross.bk")]:
        assert float(want.pop(n).abs().max()) < 1e-7 * scale and float(grads.pop(n).abs().max()) < 1e-7 * scale, n
    assert_leaves(grads, want, 1e-4, f"{arch} grad")
    moved = [n for n in grads if n.endswith(("bq", "scale", "gate", "router.w", "ln1.bias")) and
             float(grads[n].abs().max()) > 0]
    kinds = {n.rsplit(".", 1)[-1] for n in moved}
    assert "scale" in kinds
    if tcfg.qkv_bias:
        assert "bq" in kinds
    if tcfg.num_img_tokens or tcfg.num_audio_frames:
        assert "gate" in kinds
    if tcfg.moe is not None:
        assert "w" in kinds  # the router



def check_remat(arch):
    """``remat`` recomputes each cycle repeat (each encoder layer) in the
    backward: the loss and every gradient equal those without it, bit for
    bit; prefill's last logits equal forward_train's last row."""
    _, tcfg = cfgs(arch)
    params = {n: p.detach() for n, p in build_model(tcfg, device="cpu").named_parameters()}
    batch = as_torch(make_batch(tcfg))
    out = {}
    for remat in (False, True):
        lm = LM(dataclasses.replace(tcfg, remat=remat), device="meta")
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        loss = lm.loss_fn(leaves, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    lm = build_model(tcfg, device="cpu", params=params)
    logits, _ = lm.forward_train(params, batch["tokens"], batch.get("context"))
    last, _ = lm.prefill(batch["tokens"], max_len=32, context=batch.get("context"))
    np.testing.assert_allclose(last.numpy(), logits[:, -1].detach().numpy(), atol=1e-6, rtol=0)

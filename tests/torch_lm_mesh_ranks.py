"""The rank program of ``tests/test_torch_lm_mesh.py``: the LM on a
``torch.distributed`` device mesh of ``gloo`` ranks on the CPU.

:func:`spawn` starts ``world`` processes through
``tests/torch_sharding_ranks.py``'s spawn, each running :func:`rank_checks`
on every mesh of ``MESHES[world]``, ``("data", "model")`` axes, the same
calls in the same order. Each rank also runs every case unsharded itself,
compares on the spot and sends back errors, equalities and counts (plain
numbers, small lists), never whole tensors (those go to files, below). A
rank that raises sends its traceback; the spawn raises then, or when the
ranks run past the timeout.

Cases, per mesh:

  * ``train``: one sharded ``make_train_step`` step (``grad_accum`` 2, a
    (4, 32) batch) against the unsharded step on the same seeded
    parameters, the vectors (norm scales, biases, gates) redrawn so that
    each moves the loss: the loss's relative error, each updated
    parameter's and AdamW first moment's (0.1 × the clipped gradient at
    step 1) max error over that tensor's max magnitude;
  * ``decode``: prefill (4, 16) into 32 positions and 4 decode steps under
    the mesh against one device's logits (gemma3-4b smoke pruned, with
    and without ``hier_topk``; qwen2-1.5b and olmoe-1b-7b smoke; the
    recurrent and cross-attention archs recurrentgemma-2b, rwkv6-3b,
    llama-3.2-vision-90b and seamless-m4t-medium smoke on the 4-rank mesh,
    a 16-row context for the last two, unpruned and at K 8), and on the
    4-rank mesh the same steps with the weights placed by
    ``params_shardings`` bit for bit the whole-weight ones; the
    split pruned decode through the mesh's collectives
    (``MeshComm``) against unsplit kernel #4's kept positions, tie-free
    and tie-heavy;
  * ``restore``: rank 0 trains qwen2-1.5b smoke two steps unsharded with a
    checkpoint; every rank restores it onto the mesh
    (``Trainer.restore_for_mesh``) and takes one more step (its parameters'
    error over the largest parameter magnitude: the seeded norm scales
    start at zero and have moved only by the learning rate); the placed
    state saved back is written once and read back.

On ``REFERENCE_MESH`` the ``REFERENCE_TRAIN`` steps and the
``REFERENCE_DECODE`` runs (teacher-forced on :func:`decode_tokens`) also
write their results whole to npz files in the spawn's directory (global
rank 0), which the test holds to the reference's sharded run
(``tests/torch_lm_mesh_reference.py``).

This module imports neither JAX nor the reference: the ranks run only the
port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback

MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# (arch, overrides) of the train cases on every mesh (fsdp on; on and off
# on the 4-rank mesh), and on the 4-rank mesh only
TRAIN_ALL = (("qwen2-1.5b", {}), ("olmoe-1b-7b", {}))
TRAIN_FOUR = (("rwkv6-3b", {}), ("recurrentgemma-2b", {}), ("seamless-m4t-medium", {}),
              ("qwen2-1.5b", {"optimizer": "adafactor"}), ("qwen2-1.5b", {"remat": True}))
DECODE = (("gemma3-4b", {}), ("gemma3-4b", {"hier_topk": True}), ("qwen2-1.5b", {}), ("olmoe-1b-7b", {}))
# the recurrent and cross-attention archs (R, W, C, D decode state) on the
# 4-rank mesh, each unpruned and pruned (K 8: a C block's 16 context rows split over ranks,
# a D block's self cache too; R and W keep no global cache to prune)
DECODE_STATE = tuple((arch, over) for arch in ("recurrentgemma-2b", "rwkv6-3b", "llama-3.2-vision-90b",
                                               "seamless-m4t-medium")
                     for over in ({}, {"attn_prune_k": 8}))
BATCH, SEQ, PROMPT, MAX_LEN, GEN = 4, 32, 16, 32, 4
# the cases whose mesh results are written whole for the reference run
# sharded on the same mesh (tests/torch_lm_mesh_reference.py): train steps
# (arch, fsdp) with grad_accum 2, and pruned decodes
REFERENCE_MESH = (2, 2)
REFERENCE_TRAIN = (("qwen2-1.5b", True), ("olmoe-1b-7b", True))
REFERENCE_DECODE = (("gemma3-4b", {"hier_topk": True}), ("gemma3-4b", {}), ("recurrentgemma-2b", {}),
                    ("rwkv6-3b", {}), ("llama-3.2-vision-90b", {"attn_prune_k": 8}),
                    ("seamless-m4t-medium", {"attn_prune_k": 8}))


def reference_decode_name(arch, over) -> str:
    k = f"_k{over['attn_prune_k']}" if "attn_prune_k" in over else ""
    return f"port_decode_{arch}{'_hier' if over.get('hier_topk') else ''}{k}.npz"


def redrawn_params(cfg):
    """The LM's seeded init with every vector (norm scales and biases, QKV
    biases) and cross gate redrawn N(0, 0.3²) (1 for a gate): both zero
    at init, where a step's relative error says nothing."""
    import torch

    from repro_torch.models.lm import LM

    lm = LM(cfg, "cpu")
    lm.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(7)
    out = {}
    for name, p in lm.named_parameters():
        p = p.detach().clone()
        if p.dim() < 2:
            p = torch.randn(p.shape, generator=g) * (1.0 if name.endswith("gate") else 0.3)
        out[name] = p
    return out


def batch(cfg, seed=1):
    import torch

    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g),
           "labels": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g)}
    n = cfg.num_img_tokens or cfg.num_audio_frames
    if n:
        out["context"] = torch.randn((BATCH, n, cfg.d_model), generator=g)
    return out


def _whole(t):
    return t.full_tensor() if type(t).__name__ == "DTensor" else t


def _rel(got, want) -> float:
    return float((_whole(got) - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _state_errs(got, want) -> float:
    """Max relative error over an optimizer state's tensors."""
    from repro_torch.checkpoint import flatten_train_state

    g, w = flatten_train_state({}, got), flatten_train_state({}, want)
    return max(_rel(g[k], w[k]) for k in w if k != "opt.step")


def _dump(path, arrays) -> None:
    """Whole tensors (``full_tensor()``, a collective every rank joins)
    written to ``path`` by global rank 0 alone."""
    import numpy as np
    import torch.distributed as dist

    whole = {k: _whole(v).detach().float().numpy() for k, v in arrays.items()}
    if dist.get_rank() == 0:
        np.savez(path, **whole)


def train_case(arch, over, fsdp, mesh, dump=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import steps

    cfg = dataclasses.replace(get_config(arch, smoke=True), grad_accum=2, fsdp=fsdp, **over)
    params = redrawn_params(cfg)
    b = batch(cfg)
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    p1, s1, l1 = steps.make_train_step(cfg)(params, state, b)
    psh, osh = steps.params_shardings(cfg, mesh, params, state)
    placed = steps.place_tree(params, psh)
    pstate = steps.place_tree(state, osh)
    p2, s2, l2 = steps.make_train_step(cfg, grad_shardings=psh)(placed, pstate, b)
    out = {"loss_rel": abs(float(l2) - float(l1)) / abs(float(l1)),
           "params_rel": max(_rel(p2[n], p1[n]) for n in p1),
           "placements_kept": all(tuple(p2[n].placements) == tuple(placed[n].placements) for n in p1),
           "state_rel": _state_errs(s2, s1), "moved": sum(not bool((p1[n] == params[n]).all()) for n in p1),
           "leaves": len(p1)}
    if hasattr(s1, "mu"):  # AdamW at step 1: mu = 0.1 · the clipped gradient
        out["grad_rel"] = max(_rel(s2.mu[n], s1.mu[n]) for n in p1)
    if dump is not None:
        from repro_torch.checkpoint import flatten_train_state

        state = {k: v for k, v in flatten_train_state(p2, s2).items() if k != "opt.step"}
        _dump(dump, {"loss": l2.reshape(1), **state})
    return out


def decode_case(arch, over, mesh, placed_run: bool) -> dict:
    """Prefill and GEN steps one device and under the mesh (the LM's own
    weights, whole on every rank): the mesh logits' and caches' errors
    against one device, each cache tensor's spec against
    ``cache_shardings``'. With ``placed_run`` also under the mesh through
    ``make_prefill_step`` / ``make_decode_step`` with the weights placed
    by ``params_shardings`` (fsdp on): its logits and caches bit for bit
    the whole-weight mesh run's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.layers.attention import KVCache
    from repro_torch.models.lm import build_model, cache_tensors

    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = redrawn_params(cfg)
    lm = build_model(cfg, device="cpu", params=params)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator().manual_seed(2))
    n_ctx = cfg.num_img_tokens or cfg.num_audio_frames
    ctx = torch.randn((BATCH, n_ctx, cfg.d_model), generator=torch.Generator().manual_seed(3)) if n_ctx else None
    psh, _ = steps.params_shardings(dataclasses.replace(cfg, fsdp=True), mesh, params)
    placed = steps.place_tree(params, psh)
    prefill = steps.make_prefill_step(cfg, steps.ShapeSpec("mesh", "prefill", MAX_LEN, BATCH))
    decode = steps.make_decode_step(cfg)
    batch = {"tokens": toks} if ctx is None else {"tokens": toks, "context": ctx}
    with torch.inference_mode():
        l1, c1 = lm.prefill(toks, max_len=MAX_LEN, context=ctx)
        with sharding.set_mesh(mesh):
            l2, c2 = lm.prefill(toks, max_len=MAX_LEN, context=ctx)
            if placed_run:
                l3, c3 = prefill(placed, batch)
        errs = [float((l2.full_tensor() - l1).abs().max())]
        same = [torch.equal(l3.to_local(), l2.to_local())] if placed_run else []
        tok = l1.argmax(-1)[:, None]
        for i in range(GEN):
            a, _ = lm.decode_step(tok, PROMPT + i, c1)
            b, _ = lm.decode_step(tok, PROMPT + i, c2)
            if placed_run:
                p, _ = decode(placed, tok, PROMPT + i, c3)
                same.append(torch.equal(p.to_local(), b.to_local()))
            errs.append(float((b.full_tensor() - a).abs().max()))
            tok = a.argmax(-1)[:, None]
        t1, t2 = cache_tensors(c1), cache_tensors(c2)
        cache_err = max(float((x.full_tensor() - y).abs().max()) for x, y in zip(t2, t1))
        if placed_run:
            same.append(all(torch.equal(x.to_local(), y.to_local()) for x, y in zip(cache_tensors(c3), t2)))
    def leaves(tree):  # the cache's shardings in cache_tensors' order
        return [tree] if isinstance(tree, sharding.Sharding) else [x for part in tree for x in leaves(part)]

    specs = leaves(steps.cache_shardings(cfg, steps.ShapeSpec("mesh", "decode", MAX_LEN, BATCH), mesh, c1))
    out = {"logits_err": max(errs), "cache_err": cache_err,
           "specs_match": all(sharding.spec_of(t) == sh.spec for t, sh in zip(t2, specs)) and len(t2) == len(specs),
           "split": sorted({str(sharding.spec_of(t)) for t in t2})}
    if placed_run:
        out["placed_bitwise"] = all(same)
    if all(isinstance(c, KVCache) for c in c2):
        out["positions_split"] = [sharding.spec_of(c.k)[1] for c in c2]  # each layer's positions: over "model" or not
    return out


def decode_tokens(cfg):
    """The prompt (BATCH, PROMPT), the GEN teacher-forced decode tokens
    (GEN, BATCH, 1) and the context (BATCH, rows, d) float32 of a "vlm" or
    "audio" arch (else None) of :func:`reference_decode_case`, drawn with
    numpy."""
    import numpy as np

    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (GEN, BATCH, 1)).astype(np.int32)
    n = cfg.num_img_tokens or cfg.num_audio_frames
    return prompt, toks, (rng.standard_normal((BATCH, n, cfg.d_model)).astype(np.float32) if n else None)


def reference_decode_case(arch, over, mesh, dump) -> None:
    """Prefill and GEN teacher-forced decode steps under the mesh, the
    logits of each written whole to ``dump`` (``logits_0`` the prefill's),
    for ``tests/torch_lm_mesh_reference.py``'s sharded reference to meet."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models.lm import build_model

    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    lm = build_model(cfg, device="cpu", params=redrawn_params(cfg))
    prompt, toks, ctx = decode_tokens(cfg)
    with torch.inference_mode():
        with sharding.set_mesh(mesh):
            logits, cache = lm.prefill(torch.from_numpy(prompt).long(), max_len=MAX_LEN,
                                       context=None if ctx is None else torch.from_numpy(ctx))
        out = {"logits_0": logits}
        for i in range(GEN):
            out[f"logits_{i + 1}"], _ = lm.decode_step(torch.from_numpy(toks[i]).long(), PROMPT + i, cache)
        _dump(dump, out)


def split_ids_case(mesh) -> dict:
    """The split pruned decode through the mesh's ``model`` collectives,
    each rank on its block of positions, against unsplit kernel #4 (its
    plain version): tie-free and tie-heavy, with and without the
    hierarchical merge."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.layers import attention

    n = mesh.size(mesh.mesh_dim_names.index("model"))
    r = mesh.get_local_rank("model")
    out = {}
    for ties in (False, True):
        g = torch.Generator().manual_seed(1)
        b, h, hkv, hd, c, k = 2, 4, 2, 16, 48, 8
        if ties:
            q = torch.ones(b, h, hd)
            kc = torch.randint(-1, 2, (b, c, hkv, hd), generator=g).float()
        else:
            q, kc = torch.randn(b, h, hd, generator=g), torch.randn(b, c, hkv, hd, generator=g)
        vc = torch.randn(b, c, hkv, hd, generator=g)
        lengths = torch.tensor([c - 7, c], dtype=torch.int32)
        scale = hd ** -0.5
        want = tda.topk_decode_attention(q, kc, vc, lengths, k, scale)
        _, ids = tda.score_prune(q, kc, lengths, k, scale)
        cl = c // n
        comm = attention.MeshComm(mesh, "model")
        for hier in (False, True):
            o, got = attention.split_pruned_decode(q, kc[:, r * cl:(r + 1) * cl].contiguous(),
                                                   vc[:, r * cl:(r + 1) * cl].contiguous(), lengths, r * cl, c, k,
                                                   scale, hier, comm, return_ids=True)
            _, loop = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, hier, return_ids=True)
            out[ties, hier] = {"ids_equal_unsplit": bool(torch.equal(got, ids)),
                               "ids_equal_loopback": bool(torch.equal(got, loop)),
                               "rows_differ": int((got != ids).any(dim=-1).sum()),
                               "out_err": float((o - want).abs().max())}
    return out


def restore_case(mesh, workdir: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, flatten_train_state
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True), grad_accum=2)
    key = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    tc = TrainConfig(steps=2, seq_len=SEQ, global_batch=BATCH, ckpt_dir=os.path.join(workdir, f"ckpt_{key}"),
                     ckpt_every=2, keep=1, log_every=0)
    if dist.get_rank() == 0:
        Trainer(cfg, tc, device="cpu").run()
    dist.barrier()
    tr = Trainer(cfg, tc, device="cpu")
    (params, state), step = tr.restore_for_mesh(mesh, steps.params_shardings(cfg, mesh, *steps.state_specs(cfg, True)))
    p0, s0 = tr.init_state()
    plain = tr.ckpt.restore(step, flatten_train_state(p0, s0))
    placed = flatten_train_state(params, state)
    bitwise = all(torch.equal(_whole(placed[k]), plain[k]) for k in plain)
    split = sum(type(v).__name__ == "DTensor" and any(type(p).__name__ == "Shard" for p in v.placements)
                for v in placed.values())
    # one more step from the restored state, sharded and not
    b = tr.pipeline.batch(step, "cpu")
    from repro_torch.checkpoint import unflatten_train_state

    pp, ps = unflatten_train_state(plain, s0)
    p1, _, l1 = steps.make_train_step(cfg)(pp, ps, b)
    p2, s2, l2 = steps.make_train_step(cfg)(params, state, b)
    scale = max(float(p.abs().max()) for p in p1.values())
    out = {"step": step, "bitwise": bitwise, "placed_leaves_split": split,
           "next_loss_rel": abs(float(l2) - float(l1)) / abs(float(l1)),
           "next_params_err": max(float((_whole(p2[n]) - p1[n]).abs().max()) for n in p1) / scale}
    # the placed state saved: written once (rank 0), read back whole
    mgr = CheckpointManager(os.path.join(workdir, f"placed_{key}"), keep=1)
    whole = flatten_train_state(p2, s2)
    mgr.save(step + 1, whole, blocking=True)
    back = mgr.restore(step + 1, {k: _whole(v) for k, v in whole.items()})
    out["saved_back_bitwise"] = all(torch.equal(back[k], _whole(v)) for k, v in whole.items())
    out["saved_dirs"] = sorted(os.listdir(mgr.dir))
    return out


def constrain_case(mesh) -> dict:
    """``constrain`` on a DTensor under the mesh: redistributed to the
    resolved spec, its whole value unchanged; ``shard_batch_dim`` of a
    plain batch takes this rank's rows."""
    import torch

    from repro_torch.distributed import sharding

    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    with sharding.set_mesh(mesh):
        rows = sharding.shard_batch_dim(x)
        whole = sharding.constrain(rows, None, None)
        heads = sharding.constrain(rows, None, "heads")
    return {"rows": sharding.spec_of(rows), "whole": sharding.spec_of(whole), "heads": sharding.spec_of(heads),
            "values_kept": all(torch.equal(t.full_tensor(), x) for t in (rows, whole, heads)),
            "local_rows": rows.to_local().shape[0]}


def rank_checks(world: int, workdir: str) -> dict:
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    out: dict = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        res = out[shape] = {"rank": (mesh.get_local_rank("data"), mesh.get_local_rank("model")), "train": {},
                            "decode": {}}
        t0 = time.perf_counter()
        cases = TRAIN_ALL + (TRAIN_FOUR if world == 4 else ())
        for arch, over in cases:
            for fsdp in ((False, True) if world == 4 and not over else (True,)):
                dump = None
                if shape == REFERENCE_MESH and (arch, fsdp) in REFERENCE_TRAIN and not over:
                    dump = os.path.join(workdir, f"port_train_{arch}.npz")
                res["train"][arch, tuple(sorted(over.items())), fsdp] = train_case(arch, over, fsdp, mesh, dump)
        res["train_s"] = time.perf_counter() - t0
        for arch, over in DECODE + (DECODE_STATE if world == 4 else ()):
            res["decode"][arch, tuple(sorted(over.items()))] = decode_case(arch, over, mesh, world == 4)
        if shape == REFERENCE_MESH:
            for arch, over in REFERENCE_DECODE:
                reference_decode_case(arch, over, mesh, os.path.join(workdir, reference_decode_name(arch, over)))
        if mesh.size(1) > 1:
            res["split_ids"] = split_ids_case(mesh)
        res["constrain"] = constrain_case(mesh)
        res["restore"] = restore_case(mesh, workdir)
        res["wall_s"] = time.perf_counter() - t0
    return out


def _rank_main(rank: int, world: int, init_file: str, q) -> None:
    try:
        import torch
        import torch.distributed as tdist

        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=120))
        try:
            q.put((rank, "ok", rank_checks(world, os.path.dirname(init_file))))
        finally:
            tdist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def spawn(world: int, workdir: str, timeout: float = 300.0) -> list:
    """:func:`rank_checks` on ``world`` gloo ranks (``torch_sharding_ranks``'
    spawn: the ``spawn`` start method, a ``file://`` rendezvous in
    ``workdir``, a join timeout), their results in rank order."""
    import torch_sharding_ranks

    return torch_sharding_ranks.spawn(world, workdir, timeout, main=_rank_main)

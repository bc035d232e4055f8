"""Port parity: the LM training runtime on the CPU.

  * ``TokenPipeline`` bit for bit the reference's (steps, shards).
  * Checkpoints: a round trip bit for bit (bfloat16, int32, 0-d), the
    async save with ``keep`` garbage collection, a torn directory ignored,
    a changed shape or name rejected; the train state's flat layout.
  * The straggler monitor.
  * ``Trainer`` (qwen2-1.5b smoke): the loss falls over 30 steps; a run
    stopped at a checkpoint and resumed gives an uninterrupted run's losses
    bit for bit; a failed step is retried from the unchanged state; the
    last failure saves and raises; the trained weights are the LM's.
  * ``launch/train.py --device cpu`` (a context arch included).
  * Compression: ``quantize_int8`` / ``dequantize_int8`` and the error
    feedback bit for bit the reference's; ``compressed_psum`` on two
    ``gloo`` ranks equal to the sum of the ranks' dequantized blocks.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_compression_ranks as ranks  # noqa: E402
# autouse fixtures of every module that imports them
from torch_lm_parity import end_leaked_serve_threads, one_intra_op_thread  # noqa: E402,F401
from repro_torch.checkpoint import CheckpointManager, flatten_train_state, unflatten_train_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402
from repro_torch.runtime import TrainConfig, Trainer  # noqa: E402
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: E402


# ------------------------------------------------------------------ tokens
@pytest.mark.parametrize("shard,num_shards", ((0, 1), (1, 2)))
def test_token_pipeline_matches_reference(shard, num_shards):
    from repro.data.tokens import TokenPipeline as JPipeline

    args = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=7, shard=shard, num_shards=num_shards)
    ours, theirs = TokenPipeline(**args), JPipeline(**args)
    for step in (0, 1, 17):
        a, b = ours.batch_np(step), theirs.batch_np(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        t = ours.batch(step)
        assert t["tokens"].dtype == torch.int32 and np.array_equal(t["labels"].numpy(), b["labels"])


# ------------------------------------------------------------- checkpoints
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((8, 16), generator=g),
        "b.c": torch.arange(10, dtype=torch.int32),
        "b.d": torch.tensor(3.5),
        "e": torch.randn((5, 3), generator=g).to(torch.bfloat16),
    }


def test_checkpoint_roundtrip_bit_for_bit(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    mgr.save(7, state, blocking=True)
    assert mgr.latest_step() == 7
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["dtypes"] == ["float32", "int32", "float32", "bfloat16"]
    out = mgr.restore(7, {n: torch.empty_like(t) for n, t in state.items()})
    for n, t in state.items():
        bits = out[n].reshape(-1).view(torch.uint8)
        assert out[n].dtype == t.dtype and torch.equal(bits, t.reshape(-1).view(torch.uint8)), n


def test_async_save_snapshots_and_gc(tmp_path):
    """The snapshot is taken before ``save`` returns: writing the tensors
    afterwards changes nothing saved; ``keep=2`` leaves the last two."""
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        state = _state(s)
        mgr.save(s, state, blocking=False)
        state["a"].fill_(-1.0)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    out = mgr.restore(4, _state())
    assert torch.equal(out["a"], _state(4)["a"]) and mgr.last_write["bytes"] > 0


def test_torn_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _state(), blocking=True)
    torn = tmp_path / "step_9"
    torn.mkdir()
    (torn / "manifest.json").write_text(json.dumps({"step": 9}))
    assert mgr.latest_step() == 5  # no COMMITTED sentinel -> invisible


def test_restore_rejects_shape_or_name_change(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros((4, 4))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.empty((8, 4))})
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(1, {"v": torch.empty((4, 4))})


def test_restore_reads_stored_members_and_rejects_compressed(tmp_path):
    """``restore`` maps the archive's members in place (``npz.mmap_views``):
    a transposed tensor, stored in Fortran order, comes back bit for bit;
    an archive of compressed members, which ``save`` never writes, raises."""
    import zipfile

    state = {"t": torch.randn((6, 4), generator=torch.Generator().manual_seed(3)).T, **_state()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state, blocking=True)
    npz = tmp_path / "step_2" / "arrays.npz"
    with np.load(npz) as z:
        assert np.isfortran(z["t"])
    out = mgr.restore(2, {n: torch.empty(t.shape, dtype=t.dtype) for n, t in state.items()})
    for n, t in state.items():
        assert torch.equal(out[n].reshape(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8)), n
    with zipfile.ZipFile(npz) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    np.savez_compressed(npz, **arrays)
    with pytest.raises(ValueError, match="uncompressed"):
        mgr.restore(2, state)


def test_train_state_layout_round_trip():
    """``opt.step``, ``opt.slots.<name>.row|col|full`` (only the parts set),
    and back."""
    params = {"w": torch.ones(3, 4), "v": torch.ones(5)}
    opt = adafactor(stacks=[["v"]])
    state = opt.init(params)
    flat = flatten_train_state(params, state)
    assert sorted(flat) == ["opt.slots.v.col", "opt.slots.v.row", "opt.slots.w.col", "opt.slots.w.row",
                            "opt.step", "params.v", "params.w"]
    p2, s2 = unflatten_train_state(flat, state)
    assert p2.keys() == params.keys() and s2.slots["w"].full is None and s2.slots["v"].row.shape == ()


# ---------------------------------------------------------------- straggler
def test_straggler_monitor_fires():
    fired = []
    mon = StragglerMonitor(window=16, threshold=1.5, on_straggler=lambda *a: fired.append(a))
    for i in range(12):
        mon.step_start()
        time.sleep(0.002)
        mon.step_end(i)
    mon.step_start()
    time.sleep(0.05)  # straggler
    mon.step_end(99)
    assert any(e[0] == 99 for e in fired)


# ------------------------------------------------------------------ trainer
def _cfg(**over):
    """qwen2-1.5b's smoke config with flash chunks of 16 (see
    ``torch_lm_parity.cfgs``)."""
    return dataclasses.replace(get_config("qwen2_1_5b", smoke=True), attn_chunk_q=16, attn_chunk_kv=16, **over)


def _tcfg(tmp_path, name, **over):
    return TrainConfig(**{**dict(steps=8, seq_len=32, global_batch=8, ckpt_dir=str(tmp_path / name),
                                 ckpt_every=4, log_every=0), **over})


def test_short_training_loss_decreases(tmp_path):
    tr = Trainer(_cfg(grad_accum=1), _tcfg(tmp_path, "a", steps=30, ckpt_every=10), device="cpu")
    params, _, losses = tr.run()
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert tr.ckpt.steps() == [10, 20, 30]
    # the trained weights are the LM's: serving it reads them
    assert all(p.data_ptr() == params[n].data_ptr() for n, p in tr.model.named_parameters())


def test_resume_equals_uninterrupted_run(tmp_path):
    """Stop at step 4 (its checkpoint written asynchronously), resume in a
    new ``Trainer``: steps 4–7 give the uninterrupted run's losses bit for
    bit, and the same parameters."""
    cfg = _cfg()  # grad_accum 4: microbatches of 2
    whole_params, _, whole = Trainer(cfg, _tcfg(tmp_path, "whole"), device="cpu").run()
    first = Trainer(cfg, _tcfg(tmp_path, "split", steps=4, ckpt_every=2), device="cpu")
    _, _, head = first.run()
    assert first.ckpt.steps() == [2, 4] and head == whole[:4]
    second = Trainer(cfg, _tcfg(tmp_path, "split"), device="cpu")
    params, state, tail = second.run()
    assert tail == whole[4:], (tail, whole)
    assert int(state.step) == 8 and all(torch.equal(params[n], whole_params[n]) for n in params)


def test_failed_step_retried_from_unchanged_state(tmp_path):
    """A step that raises on its first attempt is re-run from the same
    state (the step writes none of its inputs), and the run's losses are an
    uninterrupted run's; after the last retry the state is saved, blocking,
    and the error raised."""
    cfg = _cfg(grad_accum=1)
    _, _, clean = Trainer(cfg, _tcfg(tmp_path, "clean", steps=4), device="cpu").run()
    tr = Trainer(cfg, _tcfg(tmp_path, "flaky", steps=4), device="cpu")
    step_fn, seen = tr.step_fn, []

    def flaky(params, opt_state, batch):
        seen.append({n: p.clone() for n, p in params.items()})
        out = step_fn(params, opt_state, batch)
        if len(seen) == 3:  # the first attempt of step 2 fails after computing
            raise RuntimeError("injected transient failure")
        return out

    tr.step_fn = flaky
    _, _, losses = tr.run()
    assert len(seen) == 5 and losses == clean
    assert all(torch.equal(seen[2][n], seen[3][n]) for n in seen[2])

    def broken(params, opt_state, batch):
        raise RuntimeError("injected permanent failure")

    tr = Trainer(cfg, _tcfg(tmp_path, "broken", steps=4, max_retries=1), device="cpu")
    tr.step_fn = broken
    with pytest.raises(RuntimeError, match="permanent"):
        tr.run()
    assert tr.ckpt.steps() == [0]


@pytest.mark.parametrize("arch", ("qwen2-1.5b", "seamless-m4t-medium"))
def test_train_cli_on_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device cpu``;
    seamless trains on its stub frames."""
    ckpt = tmp_path / "ckpt"
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "4", "--ckpt-dir", str(ckpt), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "[train] done: first loss" in out
    assert CheckpointManager(ckpt).latest_step() == 2


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("n", (1, 255, 256, 257, 1000))
def test_quantize_matches_reference_bit_for_bit(n):
    from repro.distributed import compression as jcomp

    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 3
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    y = tcomp.dequantize_int8(q, s, (n,), torch.float32)
    assert np.array_equal(y.numpy(), np.asarray(jcomp.dequantize_int8(jq, js, (n,), jnp.float32)))


def test_error_feedback_matches_reference():
    from repro.distributed import compression as jcomp

    g = np.random.default_rng(0).normal(size=(512,)).astype(np.float32)
    resid, jresid = tcomp.init_feedback({"w": torch.from_numpy(g)}), jcomp.init_feedback({"w": jnp.asarray(g)})
    total = torch.zeros(512)
    for _ in range(20):
        sent, resid = tcomp.compress_tree_with_feedback({"w": torch.from_numpy(g)}, resid)
        jsent, jresid = jcomp.compress_tree_with_feedback({"w": jnp.asarray(g)}, jresid)
        assert np.array_equal(sent["w"].numpy(), np.asarray(jsent["w"]))
        assert np.array_equal(resid["w"].numpy(), np.asarray(jresid["w"]))
        total += sent["w"]
    assert float((total - 20 * torch.from_numpy(g)).abs().max()) < float(np.abs(g).max())


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    n = 1000
    outs = ranks.spawn(2, str(tmp_path), n)
    want = torch.zeros(n)
    for r in range(2):
        q, s = tcomp.quantize_int8(torch.from_numpy(ranks.rank_input(r, n)))
        want += tcomp.dequantize_int8(q, s, (n,), torch.float32)
    for out in outs:
        assert np.array_equal(out, want.numpy())

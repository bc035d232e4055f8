"""The LM on a ``torch.distributed`` device mesh of 2 and 4 ``gloo`` ranks
on the CPU (``tests/torch_lm_mesh_ranks.py``; one spawn per world size,
every case of its meshes inside it), held to one device in float32:

  * the sharded train step (``make_train_step`` on DTensor parameters and
    state placed by ``params_shardings``, ``grad_accum`` 2): qwen2-1.5b and
    olmoe-1b-7b on meshes (2, 1), (1, 2) and (2, 2), rwkv6-3b,
    recurrentgemma-2b and seamless-m4t-medium on (2, 2), ``fsdp`` on and
    off; qwen2 with Adafactor and with ``remat`` on (2, 2): loss within
    1e-6 relative, updated parameters, AdamW's first moment (the clipped
    gradient) and the optimizer state within 1e-5 of each tensor's max
    magnitude, placements kept, every leaf moved (fsdp on and off on (2, 2),
    on on the 2-rank meshes);
  * decode under the mesh (gemma3-4b smoke pruned, with and without
    ``hier_topk``; qwen2-1.5b and olmoe-1b-7b smoke; recurrentgemma-2b,
    rwkv6-3b, llama-3.2-vision-90b and seamless-m4t-medium smoke on (2, 2),
    unpruned and at K 8): prefill and 4 steps, logits and caches within 1e-5 of one
    device, every cache tensor placed by ``cache_shardings``, and on (2, 2)
    the same steps through ``make_prefill_step`` / ``make_decode_step``
    with the weights placed by ``params_shardings`` bit for bit; the split
    pruned decode
    through the mesh's collectives keeps kernel #4's positions (tie-free;
    on the tie case the gathered-logits path still does, the hierarchical
    merge keeps other tied positions in 8 of 8 rows, as the loopback does);
  * ``constrain`` redistributing a DTensor to the resolved spec, and
    ``shard_batch_dim`` taking each rank's rows;
  * ``Trainer.restore_for_mesh``: an unsharded checkpoint restored onto
    each mesh bit for bit, the next step within tolerance, a placed state
    saved once and read back bit for bit;
  * the port on the (2, 2) mesh against the reference run sharded on a
    (2, 2) mesh of 4 CPU devices (``tests/torch_lm_mesh_reference.py``,
    in its own process while the ranks run): the train step of qwen2-1.5b
    and olmoe-1b-7b (fsdp, ``grad_accum`` 2; loss 1e-6 relative,
    parameters and AdamW moments 1e-5 of their max), gemma3-4b's pruned
    decode with and without ``hier_topk``, recurrentgemma-2b's and
    rwkv6-3b's decode and llama-3.2-vision-90b's and
    seamless-m4t-medium's at K 8 (logits 1e-5).

Worker time: ~12 s for the 2-rank spawn, ~32 s for the 4-rank one alone
(the reference run, ~15 s, beside them); ~1.5× that in a full parallel
run.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_lm_mesh_ranks as ranks  # noqa: E402

TOL_LOSS, TOL_REL, TOL_LOGITS = 1e-6, 1e-5, 1e-5
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    return {w: tmp_path_factory.mktemp(f"lm_gloo{w}") for w in (2, 4)}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """``tests/torch_lm_mesh_reference.py`` started in a process of its own
    (a forced 4-device CPU backend on one intra-op thread, beside the
    ranks' four), running while the ranks run."""
    outdir = tmp_path_factory.mktemp("lm_reference")
    flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_lm_mesh_reference.py"), str(outdir)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, outdir
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def results(reference_run, workdirs):
    """Both spawns, each rank's results by mesh shape."""
    return {w: ranks.spawn(w, str(workdirs[w]), timeout=300.0) for w in (2, 4)}


@pytest.fixture(scope="module")
def sharded_reference(reference_run, results):
    """The directory of the reference's sharded results."""
    proc, outdir = reference_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return outdir


def _world(shape):
    return shape[0] * shape[1]


TRAIN = [(shape, arch, tuple(sorted(over.items())), fsdp)
         for world, shapes in ranks.MESHES.items() for shape in shapes
         for arch, over in ranks.TRAIN_ALL + (ranks.TRAIN_FOUR if world == 4 else ())
         for fsdp in ((False, True) if world == 4 and not over else (True,))]


@pytest.mark.parametrize("shape,arch,over,fsdp", TRAIN, ids=lambda v: str(v).replace(" ", ""))
def test_sharded_train_step_equals_one_device(results, shape, arch, over, fsdp):
    for r in results[_world(shape)]:
        got = r[shape]["train"][arch, over, fsdp]
        assert got["loss_rel"] <= TOL_LOSS, got
        assert got["params_rel"] <= TOL_REL, got
        assert got["state_rel"] <= TOL_REL, got
        if "grad_rel" in got:
            assert got["grad_rel"] <= TOL_REL, got
        assert got["placements_kept"] and got["moved"] == got["leaves"], got


DECODE = [(shape, arch, tuple(sorted(over.items()))) for world, shapes in ranks.MESHES.items() for shape in shapes
          for arch, over in ranks.DECODE + (ranks.DECODE_STATE if world == 4 else ())]


@pytest.mark.parametrize("shape,arch,over", DECODE, ids=lambda v: str(v).replace(" ", ""))
def test_decode_on_mesh_equals_one_device(results, shape, arch, over):
    """Prefill and 4 steps under the mesh within 1e-5 of one device, the
    caches placed by ``cache_shardings``; on (2, 2) the same run with the
    weights placed by ``params_shardings`` (fsdp) bit for bit the
    whole-weight one."""
    for r in results[_world(shape)]:
        got = r[shape]["decode"][arch, over]
        assert got["logits_err"] <= TOL_LOGITS and got["cache_err"] <= TOL_LOGITS, got
        assert got["specs_match"], got
        assert got["placed_bitwise"] if _world(shape) == 4 else "placed_bitwise" not in got, got
        if "positions_split" in got:
            # every cache's positions divide the "model" axis, so the spec names it
            # on every mesh, one rank on it included (that split runs unsplit)
            assert set(got["positions_split"]) == {"model"}, got
        else:  # recurrent states' heads / widths and context rows name "model" too
            assert any("model" in spec for spec in got["split"]), got


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_split_pruned_decode_through_the_mesh(results, shape):
    for r in results[_world(shape)]:
        got = r[shape]["split_ids"]
        for hier in (False, True):
            tie_free = got[False, hier]
            assert tie_free["ids_equal_unsplit"] and tie_free["out_err"] <= TOL_LOGITS, tie_free
        assert got[True, False]["ids_equal_unsplit"]  # the gathered-logits path on ties: K1's domain
        tie = got[True, True]
        assert tie["ids_equal_loopback"] and not tie["ids_equal_unsplit"] and tie["rows_differ"] == 8, tie


@pytest.mark.parametrize("shape", [s for shapes in ranks.MESHES.values() for s in shapes])
def test_constrain_redistributes_dtensors(results, shape):
    for r in results[_world(shape)]:
        got = r[shape]["constrain"]
        # the specs name an axis whatever its size, a one-rank one included
        assert got["rows"] == ("data", None) and got["whole"] == (None, None), got
        assert got["heads"] == (None, "model"), got
        assert got["values_kept"] and got["local_rows"] == 4 // shape[0], got


@pytest.mark.parametrize("shape", [s for shapes in ranks.MESHES.values() for s in shapes])
def test_restore_for_mesh(results, shape):
    for r in results[_world(shape)]:
        got = r[shape]["restore"]
        assert got["step"] == 2 and got["bitwise"], got
        assert got["placed_leaves_split"] > 0, got
        assert got["next_loss_rel"] <= TOL_LOSS and got["next_params_err"] <= TOL_REL, got
        assert got["saved_back_bitwise"] and got["saved_dirs"] == ["step_3"], got


def _held(got, want, key, rel):
    g, w = got[key], want[key]
    assert g.shape == w.shape, key
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-30)) <= rel


@pytest.mark.parametrize("arch,fsdp", ranks.REFERENCE_TRAIN)
def test_sharded_train_step_equals_sharded_reference(workdirs, sharded_reference, arch, fsdp):
    """The port's sharded step on the (2, 2) mesh (``grad_accum`` 2; for
    olmoe the load-balance loss's means averaged over the data ranks)
    against the reference's ``make_train_step(grad_shardings=)`` jitted on a
    (2, 2) mesh of 4 CPU devices, from the same parameters and batch: the
    loss within 1e-6 relative, every parameter and AdamW moment within 1e-5
    of its largest magnitude."""
    got = np.load(workdirs[4] / f"port_train_{arch}.npz")
    want = np.load(sharded_reference / f"ref_train_{arch}.npz")
    assert set(got.files) == set(want.files)
    assert abs(float(got["loss"][0]) - float(want["loss"][0])) <= TOL_LOSS * abs(float(want["loss"][0]))
    bad = [k for k in want.files if k != "loss" and not _held(got, want, k, TOL_REL)]
    assert not bad, bad


@pytest.mark.parametrize("arch,over", ranks.REFERENCE_DECODE, ids=lambda v: str(v).replace(" ", ""))
def test_decode_on_mesh_equals_sharded_reference(workdirs, sharded_reference, arch, over):
    """gemma3-4b smoke pruned (K 8), with and without ``hier_topk``, on the
    (2, 2) mesh (each rank 16 of the 32 cache positions), and the
    recurrent and cross-attention archs (states split over ``model``, the
    16 context rows 8 a rank): the prefill's and 4 teacher-forced steps'
    logits within 1e-5 of the reference's prefill and decode steps jitted
    with ``cache_shardings`` on a (2, 2) mesh, where ``_hier_topk`` takes
    its shard-local pass."""
    name = ranks.reference_decode_name(arch, over)
    got = np.load(workdirs[4] / name)
    want = np.load(sharded_reference / ("ref_" + name[len("port_"):]))
    assert set(got.files) == set(want.files) == {f"logits_{i}" for i in range(ranks.GEN + 1)}
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k].reshape(got[k].shape), atol=TOL_LOGITS, rtol=0, err_msg=k)

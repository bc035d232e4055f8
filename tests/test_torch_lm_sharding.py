"""The port's LM sharding specs (``distributed/sharding.py``,
``launch/steps.py``) held entry for entry to the reference's, with no
device:

  * ``param_logical_axes`` on every leaf path of the ten archs' smoke
    parameters and their AdamW and Adafactor states, ``fsdp`` on and off,
    and the reference's own twelve cases (``tests/test_sharding.py``);
  * ``resolve_spec`` and ``params_shardings`` / ``param_sharding_tree``
    against the reference under its ``AbstractMesh`` on (2, 4) ``data,
    model``, (2, 2, 4) ``pod, data, model`` and (1, 1), with
    ``long_500k``'s ``cache_seq`` override; the port's per-layer leaf takes
    its stacked leaf's spec without the layer dim, and the slots' pattern
    quirks (anchored patterns miss them, a short leaf truncates the names)
    come out the same;
  * ``data_shardings`` and ``cache_shardings`` (KV, RG-LRU and RWKV
    states, "D" caches) against the reference run in a subprocess on a
    forced 16-device CPU mesh with ``Auto`` axes;
  * ``to_placements`` and ``constrain``'s no-mesh contract;
  * ``hier_topk`` against the reference's ``_hier_topk`` on tie-free
    logits, its fallback, and the kernel-rule split decode
    (``split_pruned_decode_loopback``) against unsplit kernel #4's plain
    version, the tie case recorded;
  * ``attention_decode`` on 2 and 4 ranks run as threads
    (``ThreadLoopback``): pruned (gathered logits and ``hier_topk``),
    dense and a wrapped local ring against the unsplit decode, the write
    landing on the rank that owns the slot.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.layers.attention import _hier_topk  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels.topk_decode_attention import ops as tda  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.layers import attention  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"2x4": {"data": 2, "model": 4}, "2x2x4": {"pod": 2, "data": 2, "model": 4}, "1x1": {"data": 1, "model": 1}}


def abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes), axis_types=(AxisType.Auto,) * len(sizes))


def spec_tuple(p):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def ref_leaves(tree):
    return {jsh._path_str(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def both(arch, **over):
    return dataclasses.replace(jget(arch, smoke=True), **over), dataclasses.replace(tget(arch, smoke=True), **over)


# ---------------------------------------------------------------------------
# param_logical_axes
# ---------------------------------------------------------------------------

REFERENCE_CASES = [  # tests/test_sharding.py::test_param_patterns
    ("embed/table", 2, False, ("vocab", None)),
    ("groups/0/0/attn/wq", 3, False, (None, None, "heads")),
    ("groups/0/0/attn/wq", 3, True, (None, "fsdp", "heads")),
    ("groups/0/1/mlp/wi", 3, False, (None, None, "ffn")),
    ("groups/0/1/mlp/wo", 3, True, (None, "ffn", "fsdp")),
    ("groups/0/0/moe/experts/wi", 4, True, (None, "experts", "fsdp", "ffn")),
    ("groups/0/0/moe/router/w", 3, False, (None, None, "experts")),
    ("lm_head/w", 2, True, ("fsdp", "vocab")),
    ("groups/0/0/rwkv/wk2", 3, False, (None, None, "ffn")),
    ("groups/0/0/lru/wx", 3, False, (None, None, "lru")),
    ("final_norm/scale", 1, False, (None,)),
    ("mu/groups/0/0/attn/wq", 3, False, (None, None, "heads")),
]


@pytest.mark.parametrize("path,ndim,fsdp,want", REFERENCE_CASES)
def test_param_patterns_reference_cases(path, ndim, fsdp, want):
    assert sharding.param_logical_axes(path, ndim, fsdp) == want
    assert jsh.param_logical_axes(path, ndim, fsdp) == want


def _ref_state(arch, optimizer):
    jcfg, _ = both(arch, optimizer=optimizer)
    return jsteps.state_specs(jcfg, with_opt=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_every_leaf(arch):
    """Every leaf of the parameters, AdamW's and Adafactor's states, with
    fsdp on and off: the port's logical axes are the reference's."""
    n = 0
    for optimizer in ("adamw", "adafactor"):
        params, opt = _ref_state(arch, optimizer)
        leaves = {**ref_leaves(params), **ref_leaves(opt)}
        for fsdp in (False, True):
            for path, leaf in leaves.items():
                assert sharding.param_logical_axes(path, leaf.ndim, fsdp) == \
                    jsh.param_logical_axes(path, leaf.ndim, fsdp), (path, fsdp)
                n += 1
    assert n > 100


def test_slot_pattern_quirks():
    """What the reference's patterns do to Adafactor's factored slots: the
    anchored ones miss them (``attn/bk``'s row is replicated); unanchored
    ones still match (``embed/table``), and a slot shorter than its
    pattern keeps the leading names: ``embed/table``'s columns (d_model,)
    resolve as ``vocab``."""
    path = ".slots/embed/table/.col"
    assert sharding.param_logical_axes(path, 1, False) == ("vocab", None)
    assert sharding.param_sharding_tree({path: (64,)}, {"data": 2, "model": 4}) == {path: ("model",)}
    assert sharding.param_logical_axes(".slots/groups/0/0/attn/bk/.row", 1, False) == (None,)
    assert sharding.param_logical_axes(".slots/groups/0/0/lru/conv_w/.row", 2, False) == (None, "lru")
    assert jsh.param_logical_axes(path, 1, False) == ("vocab", None)


# ---------------------------------------------------------------------------
# resolve_spec, param_sharding_tree / params_shardings
# ---------------------------------------------------------------------------

SPEC_CASES = [
    (("batch", "cache_seq", None, None), (4, 3104, 4, 256)),
    (("batch", "seq", "heads", None), (8, 64, 8, 16)),
    (("batch", "seq", "kv_heads", None), (8, 64, 2, 16)),
    (("batch", "act_seq", "embed"), (8, 64, 64)),
    (("batch", "seq", "ffn"), (6, 64, 96)),
    (("moe_group", None, "experts", None), (4, 32, 8, 16)),
    (("batch", "vocab"), (1, 262144)),
    (("fsdp", "heads"), (64, 64)),
    (("batch", "lru", None), (8, 2560, 4)),
    ((None, "ctx_seq", None), (2, 19, 64)),
    (("batch", None), (3, 7)),
    (("bucket_tiles", "targets", "ntype_feat"), (8, 16, 4)),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", ("default", "long_500k"))
def test_resolve_spec_equals_reference(mesh, rules):
    sizes = MESHES[mesh]
    over = {"cache_seq": ("pod", "data", "model")} if rules == "long_500k" else {}
    with jax.sharding.use_abstract_mesh(abstract(sizes)), jsh.axis_rules(over), sharding.axis_rules(over):
        for names, shape in SPEC_CASES:
            want = spec_tuple(jsh.resolve_spec(names, shape))
            assert sharding.resolve_spec(names, shape, sizes) == want, (names, shape)
    assert sharding.resolve_spec(("batch",), (8,)) is None  # no mesh


def _port_slot_leaves(params, opt):
    """(reference-style opt path suffix, port name, port tensor) of every
    optimizer-state leaf, and (prefix) for its parameter's path."""
    out = []
    if hasattr(opt, "mu"):
        for part in ("mu", "nu"):
            out += [(f".{part}/", "", name, getattr(opt, part)[name], part) for name in params]
    else:
        for name, slot in opt.slots.items():
            for part in ("row", "col", "full"):
                if getattr(slot, part) is not None:
                    out.append((".slots/", f"/.{part}", name, getattr(slot, part), part))
    return out


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_shardings_equal_reference(arch, optimizer):
    """Every parameter and optimizer-state leaf, fsdp on and off, on the
    three meshes: the port's spec is the reference's stacked leaf's without
    the layer dim (whole for an unstacked leaf, and for a stacked vector's
    shared Adafactor columns). Where the reference put a mesh axis on the
    layer dim, the port replicates: no leaf of the ten archs does."""
    on_layer_dim = []
    for fsdp in (False, True):
        jcfg, tcfg = both(arch, optimizer=optimizer, fsdp=fsdp)
        jparams, jopt = jsteps.state_specs(jcfg, with_opt=True)
        tparams, topt = steps.state_specs(tcfg, with_opt=True)
        layout = {name: path.replace(".", "/") for name, path, _ in convert.lm_layout(tcfg, jparams)}
        for key, sizes in MESHES.items():
            am = abstract(sizes)
            with jax.sharding.use_abstract_mesh(am):
                jp, jo = jsteps.params_shardings(jcfg, am, jparams, jopt)
            want = {**{k: spec_tuple(v.spec) for k, v in ref_leaves(jp).items()},
                    **{k: spec_tuple(v.spec) for k, v in ref_leaves(jo).items()}}
            shapes = {**{k: v.shape for k, v in ref_leaves(jparams).items()},
                      **{k: v.shape for k, v in ref_leaves(jopt).items()}}
            tp, to = steps.params_shardings(tcfg, sizes, tparams, topt)
            assert to.step.spec == want[".step"] == ()
            got = [(layout[name], name, tparams[name], tp[name].spec) for name in tparams]
            for prefix, suffix, name, leaf, part in _port_slot_leaves(tparams, topt):
                sh = getattr(to, part)[name] if prefix != ".slots/" else getattr(to.slots[name], part)
                got.append((prefix + layout[name] + suffix, name, leaf, sh.spec))
            assert {path for path, *_ in got} == set(want) - {".step"}
            for path, name, leaf, spec in got:
                ref = want[path]
                if len(shapes[path]) == leaf.dim() + 1:
                    if ref[0] is not None:
                        on_layer_dim.append((path, ref))
                    ref = ref[1:]
                else:
                    assert tuple(shapes[path]) == tuple(leaf.shape), path
                assert spec == ref, (key, fsdp, path, name, spec, ref)
                sharding.to_placements(spec, sizes)  # every spec is a placement on its mesh
    assert on_layer_dim == []


# ---------------------------------------------------------------------------
# data_shardings and cache_shardings against the reference on a concrete mesh
# ---------------------------------------------------------------------------

_REF_PROGRAM = r"""
import json, os, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_config, ARCHS
from repro.distributed.sharding import _path_str
from repro.launch import steps

meshes = json.loads(sys.argv[1])
shapes = json.loads(sys.argv[2])
out = {}
for key, sizes in meshes.items():
    n = 1
    for v in sizes.values():
        n *= v
    mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes), axis_types=(AxisType.Auto,) * len(sizes),
                         devices=jax.devices()[:n])
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for name in shapes:
            shape = steps.smoke_shape(steps.SHAPES[name])
            rec = {"data": {k: list(v.spec) for k, v in steps.data_shardings(cfg, shape, mesh).items()}}
            if shape.kind == "decode":
                cs = steps.cache_shardings(cfg, shape, mesh, steps.cache_specs(cfg, shape))
                rec["cache"] = {_path_str(p): list(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(cs)[0]}
            out[f"{key}|{arch}|{name}"] = rec
print(json.dumps(out))
"""

CONCRETE = {"2x2x4": {"pod": 2, "data": 2, "model": 4}, "2x4": {"data": 2, "model": 4}, "1x1": {"data": 1, "model": 1}}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(scope="module")
def reference_io_specs():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=16", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_PROGRAM, json.dumps(CONCRETE), json.dumps(SHAPE_NAMES)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_cache_paths(cfg, cache):
    """The reference's path of each port cache tensor: group / cycle
    position / field (a "D" cache's parts by name)."""
    where, offset = {}, 0
    for gi, (cycle, n) in enumerate(cfg.layer_groups()):
        for i in range(n * len(cycle)):
            where[offset + i] = f"{gi}/{i % len(cycle)}"
        offset += n * len(cycle)
    out = []
    for i, c in enumerate(cache):
        parts = [("self/", c.self), ("cross/", c.cross)] if hasattr(c, "cross") else [("", c)]
        for prefix, part in parts:
            for field, t in zip(part._fields, part):
                out.append((f"{where[i]}/{prefix}.{field}", t))
    return out


@pytest.mark.parametrize("mesh", sorted(CONCRETE))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_and_cache_shardings_equal_reference(reference_io_specs, arch, mesh):
    sizes = CONCRETE[mesh]
    cfg = tget(arch, smoke=True)
    for name in SHAPE_NAMES:
        shape = steps.smoke_shape(steps.SHAPES[name])
        ref = reference_io_specs[f"{mesh}|{arch}|{name}"]
        got = {k: v.spec for k, v in steps.data_shardings(cfg, shape, sizes).items()}
        assert got == {k: spec_tuple(v) for k, v in ref["data"].items()}, (name, got)
        if shape.kind != "decode":
            continue
        cache = steps.cache_specs(cfg, shape)
        specs = steps.cache_shardings(cfg, shape, sizes, cache)
        ref_cache = {k: spec_tuple(v) for k, v in ref["cache"].items()}
        paths = _port_cache_paths(cfg, cache)
        spec_paths = _port_cache_paths(cfg, specs)
        assert {p for p, _ in paths} == set(ref_cache), name
        for (path, t), (_, sh) in zip(paths, spec_paths):
            assert sh.spec == ref_cache[path][1:], (name, path, sh.spec, ref_cache[path])
            assert len(sh.spec) == t.dim()


# ---------------------------------------------------------------------------
# placements, constrain
# ---------------------------------------------------------------------------

def test_to_placements_and_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 2, "model": 4}
    assert sharding.to_placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="dim order"):
        sharding.to_placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="no axis"):
        sharding.to_placements(("expert",), mesh)
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(("data", "data"), mesh)


def test_constrain_without_mesh_or_on_plain_tensor():
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", None) is x
    with sharding.set_mesh({"data": 2, "model": 2}):
        assert sharding.constrain(x, "batch", None) is x  # a plain tensor
        assert sharding.resolve_spec(("batch", None), (4, 8)) == ("data", None)


def test_production_mesh_raises_without_its_world():
    from repro_torch.launch import mesh as mesh_lib

    with pytest.raises(ValueError, match="256"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


# ---------------------------------------------------------------------------
# hier_topk and the kernel-rule split decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,k,sizes", [
    (64, 8, {"data": 2, "model": 4}),  # 4 shards of 16
    (96, 12, {"pod": 2, "data": 2, "model": 4}),
    (64, 20, {"data": 2, "model": 4}),  # 16 a shard < 20: the global top-K
    (63, 8, {"data": 2, "model": 4}),  # 63 does not divide: one shard
    (64, 8, {"data": 2, "model": 1}),  # one shard
])
def test_hier_topk_equals_reference(c, k, sizes):
    rng = np.random.default_rng(c + k)
    logits = rng.normal(size=(2, 2, 3, c)).astype(np.float32)  # tie-free
    with jax.sharding.use_abstract_mesh(abstract(sizes)):
        jv, ji = _hier_topk(jnp.asarray(logits), k, c)
    tv, ti = attention.hier_topk(torch.from_numpy(logits), k, c, mesh=sizes)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    gv, gi = jax.lax.top_k(jnp.asarray(logits), k)  # exact: a global top-K
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(gv))


def _decode_inputs(seed, b=2, h=4, hkv=2, hd=16, c=48, ties=False):
    g = torch.Generator().manual_seed(seed)
    if ties:
        q = torch.ones(b, h, hd)
        kc = torch.randint(-1, 2, (b, c, hkv, hd), generator=g).float()
    else:
        q, kc = torch.randn(b, h, hd, generator=g), torch.randn(b, c, hkv, hd, generator=g)
    vc = torch.randn(b, c, hkv, hd, generator=g)
    return q, kc, vc, torch.tensor([c - 7, c], dtype=torch.int32)[:b]


@pytest.mark.parametrize("hier", (False, True))
@pytest.mark.parametrize("n", (2, 4))
def test_split_pruned_decode_equals_unsplit_kernel(n, hier):
    """Tie-free float32: the split decode keeps kernel #4 K1's positions and
    its output is within 1e-5 of the unsplit pair's (on the CPU: their
    plain versions)."""
    k, scale = 8, 16 ** -0.5
    q, kc, vc, lengths = _decode_inputs(n)
    want = tda.topk_decode_attention(q, kc, vc, lengths, k, scale)
    _, ids = tda.score_prune(q, kc, lengths, k, scale)
    out, got = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, hier, return_ids=True)
    assert torch.equal(got, ids)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_split_pruned_decode_ties_recorded():
    """Integer logits (q all ones, keys in {-1, 0, 1}), K 8 of 48 (41
    valid in row 0): the gathered-logits path keeps K1's domain exactly at
    2 and 4 shards (the Pruner applies K1's rule to K1's logits, in stream
    order); the hierarchical merge keeps other tied positions in 8 of the 8
    (batch, q-head) rows at 2 shards and 4 at 4 shards, each shard's domain
    evicting its own first minimum. Every row keeps K logits of the same
    values, so a row differs only in which tied positions' V it reads."""
    k, scale = 8, 16 ** -0.5
    q, kc, vc, lengths = _decode_inputs(1, ties=True)
    _, ids = tda.score_prune(q, kc, lengths, k, scale)
    logits = tda.ref.score_logits_plain(q, kc, scale)
    kept = lambda i: torch.sort(torch.gather(logits, 2, i.long()), dim=-1).values  # noqa: E731
    differ = {}
    for n in (2, 4):
        _, flat_ids = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, False, return_ids=True)
        _, hier_ids = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, True, return_ids=True)
        assert torch.equal(flat_ids, ids)
        differ[n] = int((hier_ids != ids).any(dim=-1).sum())
        assert torch.equal(kept(hier_ids), kept(ids))
    assert differ == {2: 8, 4: 4}


SPLIT_LAYERS = [  # (kind, attn_prune_k, hier_topk, cache positions, decode position)
    ("A", 8, False, 32, 20),  # pruned, the logits gathered
    ("A", 8, True, 32, 20),  # pruned, the merge of shard-local top-K (at 4 ranks a block holds K)
    ("A", None, False, 32, 20),  # dense: the flash-decode merge
    ("L", None, False, 16, 37),  # a local ring, wrapped past its window
]


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("kind,prune_k,hier,c,pos", SPLIT_LAYERS)
def test_split_decode_on_thread_ranks_equals_unsplit(kind, prune_k, hier, c, pos, n):
    """``attention_decode`` on n ranks run as threads of one process
    (``ThreadLoopback``), each holding its block of the cache's positions:
    every rank's output within 1e-5 of the unsplit decode, and the new
    K / V written on the rank that owns the slot alone (the blocks joined
    equal the unsplit cache after its write, bit for bit)."""
    cfg = dataclasses.replace(tget("gemma3-4b", smoke=True), attn_prune_k=prune_k, hier_topk=hier)
    g = torch.Generator().manual_seed(c + pos + n)
    params = {k: torch.randn(s, generator=g) * 0.3 for k, s in attention.attention_shapes(cfg).items()}
    b, hkv, hd = 2, cfg.num_kv_heads, cfg.hd
    x = torch.randn((b, 1, cfg.d_model), generator=g)
    kc, vc = torch.randn((b, c, hkv, hd), generator=g), torch.randn((b, c, hkv, hd), generator=g)
    whole = attention.KVCache(kc.clone(), vc.clone())
    want, _ = attention.attention_decode(cfg, params, x, pos, whole, kind)
    cl = c // n
    blocks = [attention.KVCache(kc[:, r * cl:(r + 1) * cl].clone(), vc[:, r * cl:(r + 1) * cl].clone())
              for r in range(n)]
    loop = attention.ThreadLoopback(n)
    outs = loop.run([lambda r=r: attention.attention_decode(
        cfg, params, x, pos, blocks[r], kind, split=attention.PositionSplit(n, r, loop.comm(r)))[0]
        for r in range(n)])
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(torch.cat([blk.k for blk in blocks], dim=1), whole.k)
    assert torch.equal(torch.cat([blk.v for blk in blocks], dim=1), whole.v)
    assert not torch.equal(whole.k, kc)  # the write landed

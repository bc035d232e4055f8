"""Content-addressed SGB artifact cache.

The port's copy of ``repro/data/sgb_cache.py``: the same keys and the same
entry files, so for one graph and one set of build arguments both
packages compute the same key, write the same arrays under it, and load
each other's entries.

SGB (metapath composition + padded-CSC + degree bucketing + the grouped
ragged-grid relayout) is deterministic in ``(graph structure, build
arguments)``. A full-scale build is paid once per dataset; every later
process loads the finished
:class:`~repro_torch.core.hetgraph.BucketedSemanticGraph` stack (buckets +
the :class:`~repro_torch.core.hetgraph.GroupedBucketLayout` tile stack)
from one uncompressed npz.

Keying is content-addressed: ``blake2b(graph fingerprint × build kind ×
metapaths × bucket_sizes × max_degree × seed × tile constants × cache
version)``. The graph fingerprint hashes the *structure* (node counts,
relations, raw edge lists, label schema) — features don't enter SGB, so
feature-only edits keep the cache warm. Any change to bucket_sizes,
max_degree, or the kernel tile constants changes the key: stale entries
are never read, just orphaned (the cache directory is safe to delete at
any time).

An entry may also carry sharded splits of the grouped layout
(:class:`~repro_torch.core.hetgraph.ShardedBucketLayout`, one per split
count), written for a device mesh by either package and read by both.
``shards`` is not part of the key: a hit that lacks the split asked for
builds it and saves the entry again with every split it carries.

Entry point: :func:`build_or_load` — the drop-in replacement for calling
the ``hetgraph.build_*`` functions directly, used by ``pipeline.prepare``.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import trace
from repro_torch.core import hetgraph
from repro_torch.core.hetgraph import (
    BucketedSemanticGraph,
    DegreeBucket,
    GroupedBucketLayout,
    HetGraph,
    ShardedBucketLayout,
)
from repro_torch.npz import mmap_views

CACHE_VERSION = 1

KINDS = ("metapath", "relation", "union")


def default_cache_dir() -> Optional[Path]:
    """The opt-in ambient cache: ``$REPRO_SGB_CACHE`` when set, else
    ``None``. :func:`build_or_load` falls back to this when no explicit
    ``cache_dir`` is given, so exporting the variable activates the cache
    for every ``pipeline.prepare`` in the process."""
    env = os.environ.get("REPRO_SGB_CACHE")
    return Path(env) if env else None


def _tile_constants() -> Tuple[int, int]:
    """The grouped kernel's tile shape, which every entry is keyed on and
    carries its grouped layout for."""
    from repro_torch.kernels.fused_prune_aggregate.ops import T_TILE, W_TILE

    return int(T_TILE), int(W_TILE)


def graph_fingerprint(g: HetGraph) -> str:
    """Structure hash: node counts, relations, raw edge lists, label
    schema. Features are excluded — SGB never reads them.

    Memoized on the graph object. Structural edits after the first cache
    use must build a new ``HetGraph`` — in-place edge mutation would reuse
    the stale hash."""
    fp = getattr(g, "_fingerprint", None)
    if fp is not None:
        return fp
    h = hashlib.blake2b(digest_size=16)

    def u(*parts):
        for p in parts:
            h.update(str(p).encode())
            h.update(b"\0")

    u("fp", CACHE_VERSION)
    for t in g.node_types:
        u(t, g.num_nodes[t])
    for (src_t, name, dst_t) in g.relations:
        u("rel", src_t, name, dst_t)
        src, dst = g.edges[name]
        h.update(np.ascontiguousarray(src, np.int64).tobytes())
        h.update(np.ascontiguousarray(dst, np.int64).tobytes())
    u("label", g.label_type, g.num_classes)
    fp = h.hexdigest()
    g._fingerprint = fp
    return fp


def structure_hash(g: HetGraph) -> str:
    """Public structure hash of a graph — the fingerprint every cache key
    embeds. Two graphs compare structurally equal iff their hashes match;
    a graph with other edges gets another hash, so it can never hit an
    entry built for the first. Same memoization caveat as
    :func:`graph_fingerprint`: never mutate ``edges`` in place on a graph
    that has already been hashed."""
    return graph_fingerprint(g)


def cache_key(
    g: HetGraph,
    kind: str,
    *,
    metapaths: Optional[Dict[str, Sequence[str]]] = None,
    max_degree: Optional[int] = None,
    seed: int = 0,
    bucket_sizes: Union[Sequence[int], str, None] = None,
    t_tile: int = 8,
    w: int = 8,
) -> str:
    """Content address of one SGB artifact."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    params = {
        "kind": kind,
        "metapaths": (
            {k: list(v) for k, v in metapaths.items()} if metapaths else None
        ),
        "max_degree": max_degree,
        "seed": seed,
        "bucket_sizes": (
            bucket_sizes if isinstance(bucket_sizes, str)
            else list(bucket_sizes) if bucket_sizes is not None else None
        ),
        "t_tile": t_tile,
        "w": w,
        "cache_version": CACHE_VERSION,
    }
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_fingerprint(g).encode())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# (de)serialization — one flat npz per entry, meta as an embedded JSON blob.
#
# Every array is packed into ONE 1-D blob per dtype — two or three large
# zip members in all — with an (offset, shape) index in the JSON meta;
# loading is a handful of big sequential reads plus zero-copy reshaped
# views into the blobs (hundreds of small members made np.load pay a
# per-member open and crc pass that dwarfed the bytes).
# --------------------------------------------------------------------------

_GROUPED_ARRAYS = (
    "nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket",
    "caps", "caps_pad", "row_targets", "perm",
)


class _BlobWriter:
    """Accumulates named arrays into per-dtype flat blobs + a JSON index."""

    def __init__(self):
        self._parts: Dict[str, list] = {}
        self._sizes: Dict[str, int] = {}
        self.index: Dict[str, list] = {}  # name -> [dtype_str, shape, offset]

    def add(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        dt = arr.dtype.str
        off = self._sizes.get(dt, 0)
        self._parts.setdefault(dt, []).append(arr.ravel())
        self._sizes[dt] = off + arr.size
        self.index[name] = [dt, list(arr.shape), off]

    def blobs(self) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
        """Returns ``({npz_key: blob}, {dtype_str: npz_key})``."""
        arrays, keymap = {}, {}
        for i, (dt, parts) in enumerate(sorted(self._parts.items())):
            key = f"blob{i}"
            arrays[key] = (
                np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.dtype(dt))
            )
            keymap[dt] = key
        return arrays, keymap


class _BlobReader:
    """Resolves names to reshaped views into the loaded blobs."""

    def __init__(self, z, index: Dict[str, list], keymap: Dict[str, str]):
        self._blobs = {dt: np.asarray(z[key]) for dt, key in keymap.items()}
        self._index = index

    def get(self, name: str) -> np.ndarray:
        dt, shape, off = self._index[name]
        size = 1
        for s in shape:  # not np.prod: called per array, python is faster
            size *= s
        return self._blobs[dt][off: off + size].reshape(shape)


def _pack_grouped(prefix: str, lay: GroupedBucketLayout, bw: _BlobWriter) -> dict:
    for f in _GROUPED_ARRAYS:
        bw.add(f"{prefix}.{f}", getattr(lay, f))
    return {"t_tile": lay.t_tile, "w": lay.w, "num_rows": lay.num_rows}


def _unpack_grouped(prefix: str, meta: dict, br: _BlobReader) -> GroupedBucketLayout:
    kw = {f: br.get(f"{prefix}.{f}") for f in _GROUPED_ARRAYS}
    return GroupedBucketLayout(
        t_tile=int(meta["t_tile"]), w=int(meta["w"]),
        num_rows=int(meta["num_rows"]), **kw,
    )


def save_sgb(
    path: Union[str, "os.PathLike[str]"],
    sgs: Sequence[BucketedSemanticGraph],
    *,
    keys: Optional[Sequence[str]] = None,
    t_tile: int = 8,
    w: int = 8,
    shards: Union[int, Sequence[int]] = (),
) -> Path:
    """Serialize a bucketed-SGB stack (+ grouped layouts at ``(t_tile, w)``,
    + one sharded split per entry of ``shards``: an entry can carry splits
    for several mesh sizes at once) to one npz, the reference's entry
    file. ``keys`` records dict ordering for union builds. Atomic (tmp +
    ``os.replace``) so concurrent readers never see a torn entry."""
    path = Path(path)
    if isinstance(shards, int):
        shards = (shards,) if shards > 0 else ()
    shard_ns = sorted({int(n) for n in shards if int(n) > 0})
    bw = _BlobWriter()
    metas: List[dict] = []
    for i, sg in enumerate(sgs):
        m = {
            "name": sg.name,
            "src_types": list(sg.src_types),
            "dst_type": sg.dst_type,
            "num_targets": int(sg.num_targets),
            "num_edge_types": int(sg.num_edge_types),
            "num_buckets": len(sg.buckets),
        }
        for j, b in enumerate(sg.buckets):
            p = f"s{i}.b{j}"
            bw.add(f"{p}.targets", b.targets)
            bw.add(f"{p}.nbr", b.nbr_idx)
            bw.add(f"{p}.msk", b.nbr_mask)
            bw.add(f"{p}.ety", b.edge_type)
        m["grouped"] = _pack_grouped(f"s{i}.g", sg.grouped(t_tile, w), bw)
        splits = []
        for n in shard_ns:
            sl = sg.sharded(n, t_tile, w)
            bw.add(f"s{i}.sh{n}.perm", sl.perm)
            splits.append({
                "n_shards": sl.n_shards,
                "num_rows_alloc": int(sl.num_rows_alloc),
                "num_steps_max": int(sl.num_steps_max),
                "shards": [
                    _pack_grouped(f"s{i}.sh{n}.{k}", sh, bw)
                    for k, sh in enumerate(sl.shards)
                ],
            })
        if splits:
            m["sharded"] = splits
        metas.append(m)
    arrays, keymap = bw.blobs()
    meta = {
        "cache_version": CACHE_VERSION,
        "t_tile": t_tile,
        "w": w,
        "shards": shard_ns,
        "keys": list(keys) if keys is not None else None,
        "sgs": metas,
        "blobs": keymap,
        "arrays": bw.index,
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def open_mmap_arrays(
    path: Union[str, "os.PathLike[str]"],
) -> Dict[str, np.ndarray]:
    """Read-only zero-copy views of every array in an uncompressed ``.npz``
    — e.g. a dataset dump's ``features.npz``, or a file produced with
    ``np.savez``. Fancy-indexing rows out of these views touches only the
    pages those rows cover. Falls back to an eager ``np.load`` for
    compressed archives."""
    views = mmap_views(path)
    if views is not None:
        return views
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_sgb(
    path: Union[str, "os.PathLike[str]"],
) -> Tuple[List[BucketedSemanticGraph], Optional[List[str]]]:
    """Reconstruct the bucketed-SGB stack from a saved entry (this
    package's or the reference's). Grouped layouts and sharded splits are
    injected into the graphs' layout caches so no dispatch rebuilds them.
    Arrays are zero-copy read-only views into an mmap of the
    entry when possible: whatever turns them into tensors copies them."""
    views = mmap_views(path)
    if views is not None:
        return _reconstruct_sgb(path, views)
    with np.load(path) as z:
        return _reconstruct_sgb(path, z)


def _reconstruct_sgb(
    path, z
) -> Tuple[List[BucketedSemanticGraph], Optional[List[str]]]:
    meta = json.loads(bytes(np.asarray(z["__meta__"])).decode())
    if meta.get("cache_version") != CACHE_VERSION:
        raise ValueError(
            f"{path}: cache_version {meta.get('cache_version')!r} "
            f"unsupported"
        )
    t_tile, w = int(meta["t_tile"]), int(meta["w"])
    br = _BlobReader(z, meta["arrays"], meta["blobs"])
    out: List[BucketedSemanticGraph] = []
    for i, m in enumerate(meta["sgs"]):
        buckets = []
        for j in range(m["num_buckets"]):
            p = f"s{i}.b{j}"
            buckets.append(
                DegreeBucket(
                    targets=br.get(f"{p}.targets"),
                    nbr_idx=br.get(f"{p}.nbr"),
                    nbr_mask=br.get(f"{p}.msk"),
                    edge_type=br.get(f"{p}.ety"),
                )
            )
        sg = BucketedSemanticGraph(
            name=m["name"],
            src_types=tuple(m["src_types"]),
            dst_type=m["dst_type"],
            num_targets=int(m["num_targets"]),
            buckets=tuple(buckets),
            num_edge_types=int(m["num_edge_types"]),
        )
        sg.target_perm()
        sg._grouped[(t_tile, w)] = _unpack_grouped(
            f"s{i}.g", m["grouped"], br
        )
        for sh in m.get("sharded", ()):
            n = int(sh["n_shards"])
            sg._sharded[(n, t_tile, w)] = ShardedBucketLayout(
                n_shards=n, t_tile=t_tile, w=w,
                shards=tuple(
                    _unpack_grouped(f"s{i}.sh{n}.{k}", sm, br)
                    for k, sm in enumerate(sh["shards"])
                ),
                perm=br.get(f"s{i}.sh{n}.perm"),
                num_rows_alloc=int(sh["num_rows_alloc"]),
                num_steps_max=int(sh["num_steps_max"]),
            )
        out.append(sg)
    return out, meta["keys"]


# --------------------------------------------------------------------------
# build-or-load
# --------------------------------------------------------------------------


def _build(g, kind, metapaths, max_degree, seed, bucket_sizes):
    if kind == "metapath":
        if not metapaths:
            raise ValueError("kind='metapath' needs a metapaths table")
        return hetgraph.build_metapath_graphs(
            g, metapaths, max_degree=max_degree, seed=seed,
            bucket_sizes=bucket_sizes,
        )
    if kind == "relation":
        return hetgraph.build_relation_graphs(
            g, max_degree=max_degree, seed=seed, bucket_sizes=bucket_sizes
        )
    if kind == "union":
        return hetgraph.build_union_graph(
            g, max_degree=max_degree, seed=seed, bucket_sizes=bucket_sizes
        )
    raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def build_or_load(
    g: HetGraph,
    kind: str,
    *,
    metapaths: Optional[Dict[str, Sequence[str]]] = None,
    max_degree: Optional[int] = None,
    seed: int = 0,
    bucket_sizes: Union[Sequence[int], str, None] = None,
    cache_dir: Union[str, "os.PathLike[str]", None] = None,
    shards: int = 0,
) -> Tuple[Union[List, Dict], str]:
    """Build the ``kind`` SGB stack for ``g``, or load it from the cache.

    Returns ``(result, status)`` where ``result`` matches the underlying
    ``hetgraph.build_*`` return shape (list of semantic graphs, or the
    per-dst-type dict for ``kind="union"``) and ``status`` is ``"hit"``
    (loaded), ``"miss"`` (built + saved), or ``"off"`` (no ``cache_dir``
    and no ``$REPRO_SGB_CACHE``, or a flat ``bucket_sizes=None`` build —
    only bucketed layouts are cached). A corrupt entry is treated as a
    miss and overwritten.

    ``shards`` is not part of the key: an entry can carry sharded splits
    for several mesh sizes. A hit that lacks the split asked for builds it
    and saves the entry again with every split it carries (still a hit:
    the bucket and grouped stacks were loaded, not rebuilt); any other hit
    is never written back.

    The build span ``sgb`` (``trace``; its ``status`` the one returned)
    holds ``sgb.fingerprint`` (the key), then ``sgb.load``, or
    ``sgb.build`` (with ``hetgraph``'s stages and the grouped layouts) and
    ``sgb.save``.
    """
    with trace.span("sgb", always=True, kind=kind) as sp:
        t_tile, w = _tile_constants()
        if cache_dir is None:
            cache_dir = default_cache_dir()
        if cache_dir is None or bucket_sizes is None:
            with trace.span("sgb.build", always=True):
                out = _build(g, kind, metapaths, max_degree, seed, bucket_sizes)
            sp.set(status="off")
            return out, "off"
        with trace.span("sgb.fingerprint", always=True):
            key = cache_key(
                g, kind, metapaths=metapaths, max_degree=max_degree, seed=seed,
                bucket_sizes=bucket_sizes, t_tile=t_tile, w=w,
            )
        path = Path(cache_dir) / f"sgb_{key}.npz"
        if path.is_file():
            with trace.span("sgb.load", always=True):
                try:
                    sgs, keys = load_sgb(path)
                except Exception:
                    sgs = None  # torn/stale entry: rebuild and overwrite below
            if sgs is not None:
                if shards > 0 and any((shards, t_tile, w) not in sg._sharded for sg in sgs):
                    with trace.span("sgb.save", always=True):
                        _add_split(path, sgs, keys, shards, t_tile, w)
                out = dict(zip(keys, sgs)) if keys is not None else sgs
                sp.set(status="hit")
                return out, "hit"
        with trace.span("sgb.build", always=True):
            out = _build(g, kind, metapaths, max_degree, seed, bucket_sizes)
            if isinstance(out, dict):
                keys, sgs = list(out), list(out.values())
            else:
                keys, sgs = None, out
            # materialize the execution layouts now so the entry (and every future
            # process) carries them precomputed
            for sg in sgs:
                if isinstance(sg, BucketedSemanticGraph):
                    sg.grouped(t_tile, w)
                    if shards > 0:
                        sg.sharded(shards, t_tile, w)
        if all(isinstance(sg, BucketedSemanticGraph) for sg in sgs):
            with trace.span("sgb.save", always=True):
                save_sgb(path, sgs, keys=keys, t_tile=t_tile, w=w, shards=shards)
        sp.set(status="miss")
        return out, "miss"


def _add_split(path: Path, sgs, keys, shards: int, t_tile: int, w: int) -> None:
    """Build the ``shards`` split on the loaded ``sgs`` and save the entry
    again. The split is merged into a FRESH read of the entry first: another
    process may have added other splits since ``sgs`` was loaded, and
    saving only this view would drop them (the window left costs at most
    one redundant rebuild later, never a torn entry)."""
    key = (shards, t_tile, w)
    for sg in sgs:
        sg.sharded(shards, t_tile, w)
    try:
        fresh, keys = load_sgb(path)
    except Exception:
        fresh = sgs
    for sg_f, sg_m in zip(fresh, sgs):
        sg_f._sharded.setdefault(key, sg_m._sharded[key])
    all_ns = sorted({k[0] for sg in fresh for k in sg._sharded if k[1:] == (t_tile, w)})
    save_sgb(path, fresh, keys=keys, t_tile=t_tile, w=w, shards=all_ns)

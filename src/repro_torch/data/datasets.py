"""Dataset registry + on-disk HGB/OGB-style heterograph ingestion.

The port's copy of ``repro/data/datasets.py``: the same registry, the same
dump format file for file, so either package reads the other's dumps. One
namespace unifies every way a :class:`~repro_torch.core.hetgraph.HetGraph`
enters the pipeline:

  * **registry names** — the synthetic ACM/IMDB/DBLP generators (and
    anything added via :func:`register`), parameterized by ``scale``/``seed``;
  * **on-disk dumps** — a directory in the format below (what real HGB/OGB
    exports are converted into; :func:`save_hetgraph` writes it);
  * **in-memory graphs** — a ``HetGraph`` instance passed straight through.

``pipeline.prepare(model, dataset)`` accepts all three interchangeably via
:func:`resolve`, which also schema-validates (``HetGraph.validate``) so
malformed dumps fail at ingestion, not deep inside SGB.

On-disk format (one directory per dataset)::

    meta.json      format_version, name, node_types (ordered), num_nodes,
                   relations [[src_type, rel, dst_type], ...], label_type,
                   num_classes, edge_format, feature_format, optional
                   metapaths {name: [rel, ...]}
    features.npz   one (N_t, F_t) float32 array per node type
                   (or features/{type}.csv, one row per node)
    labels.npy     (N_label_type,) integer labels
    edges.npz      {rel}__src / {rel}__dst int64 id arrays per relation
                   (or edges/{rel}.csv with a "src,dst" header row)

ids are local to their node type, exactly as ``HetGraph.edges`` stores
them. npz is the round-trip-exact format; csv is the interchange escape
hatch for hand-converted HGB ``link.dat``-style dumps (exact for integer
edge lists, repr-roundtrip for float features).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.hetgraph import HetGraph
from repro_torch.data import synthetic

FORMAT_VERSION = 1

DatasetSpec = Union[str, "os.PathLike[str]", HetGraph]

# name -> generator(scale: float, seed: int) -> HetGraph
REGISTRY: Dict[str, Callable[..., HetGraph]] = {}


def register(name: str, fn: Callable[..., HetGraph]) -> None:
    """Register a dataset generator under ``name`` (overwrites)."""
    REGISTRY[name] = fn


for _name, _fn in synthetic.DATASETS.items():
    register(_name, _fn)


def available() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


# --------------------------------------------------------------------------
# on-disk writer / reader
# --------------------------------------------------------------------------


def save_hetgraph(
    g: HetGraph,
    path: Union[str, "os.PathLike[str]"],
    name: str = "hetgraph",
    metapaths: Optional[Dict[str, Sequence[str]]] = None,
    edge_format: str = "npz",
    feature_format: str = "npz",
) -> Path:
    """Serialize ``g`` to the on-disk dump format at ``path`` (a directory,
    created if needed). ``metapaths`` lands in meta.json so HAN tasks can be
    prepared straight from the dump."""
    g.validate()
    if edge_format not in ("npz", "csv"):
        raise ValueError(f"edge_format must be npz|csv, got {edge_format!r}")
    if feature_format not in ("npz", "csv"):
        raise ValueError(
            f"feature_format must be npz|csv, got {feature_format!r}"
        )
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    # re-exporting over an existing dump: drop the other format's files so
    # nothing stale shadows this export (the loader also honors meta.json's
    # recorded formats as a second line of defense)
    if edge_format == "csv":
        (path / "edges.npz").unlink(missing_ok=True)
    else:
        shutil.rmtree(path / "edges", ignore_errors=True)
    if feature_format == "csv":
        (path / "features.npz").unlink(missing_ok=True)
    else:
        shutil.rmtree(path / "features", ignore_errors=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "name": name,
        "node_types": list(g.node_types),
        "num_nodes": {t: int(n) for t, n in g.num_nodes.items()},
        "relations": [list(r) for r in g.relations],
        "label_type": g.label_type,
        "num_classes": int(g.num_classes),
        "edge_format": edge_format,
        "feature_format": feature_format,
    }
    if metapaths:
        meta["metapaths"] = {k: list(v) for k, v in metapaths.items()}
    (path / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    if feature_format == "npz":
        np.savez(
            path / "features.npz",
            **{t: np.asarray(f, np.float32) for t, f in g.features.items()},
        )
    else:
        fdir = path / "features"
        fdir.mkdir(exist_ok=True)
        for t, f in g.features.items():
            # repr-roundtrip precision: float32 survives %.9e exactly
            np.savetxt(fdir / f"{t}.csv", np.asarray(f, np.float32),
                       fmt="%.9e", delimiter=",")
    np.save(path / "labels.npy", np.asarray(g.labels))
    if edge_format == "npz":
        arrs = {}
        for rel, (src, dst) in g.edges.items():
            arrs[f"{rel}__src"] = np.asarray(src, np.int64)
            arrs[f"{rel}__dst"] = np.asarray(dst, np.int64)
        np.savez(path / "edges.npz", **arrs)
    else:
        edir = path / "edges"
        edir.mkdir(exist_ok=True)
        for rel, (src, dst) in g.edges.items():
            pairs = np.stack(
                [np.asarray(src, np.int64), np.asarray(dst, np.int64)], axis=1
            )
            np.savetxt(edir / f"{rel}.csv", pairs, fmt="%d", delimiter=",",
                       header="src,dst", comments="")
    return path


def read_meta(path: Union[str, "os.PathLike[str]"]) -> dict:
    """Load and sanity-check a dump's meta.json."""
    path = Path(path)
    mf = path / "meta.json"
    if not mf.is_file():
        raise ValueError(f"not a dataset dump: {path} has no meta.json")
    try:
        meta = json.loads(mf.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"{mf}: invalid JSON: {e}") from e
    ver = meta.get("format_version")
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"{mf}: format_version {ver!r} unsupported (expected "
            f"{FORMAT_VERSION})"
        )
    for k in ("node_types", "num_nodes", "relations", "label_type",
              "num_classes"):
        if k not in meta:
            raise ValueError(f"{mf}: missing required key {k!r}")
    return meta


def _pick_format(path: Path, meta: dict, key: str, npz_name: str) -> str:
    """Which format to read: meta.json's recorded format wins (a stale file
    from an earlier export in the other format must not shadow it); dumps
    without the field (hand-authored) are probed by file existence."""
    fmt = meta.get(key)
    if fmt is not None:
        if fmt not in ("npz", "csv"):
            raise ValueError(f"{path}/meta.json: {key} must be npz|csv, "
                             f"got {fmt!r}")
        return fmt
    return "npz" if (path / npz_name).is_file() else "csv"


def _load_features(path: Path, meta: dict) -> Dict[str, np.ndarray]:
    types = meta["node_types"]
    out: Dict[str, np.ndarray] = {}
    if _pick_format(path, meta, "feature_format", "features.npz") == "npz":
        fnpz = path / "features.npz"
        if not fnpz.is_file():
            raise ValueError(f"{path}: missing features.npz")
        with np.load(fnpz) as z:
            for t in types:
                if t not in z:
                    raise ValueError(
                        f"{fnpz}: missing feature table for node type {t!r}"
                    )
                out[t] = np.asarray(z[t], np.float32)
        return out
    fdir = path / "features"
    for t in types:
        fcsv = fdir / f"{t}.csv"
        if not fcsv.is_file():
            raise ValueError(
                f"{path}: no features.npz and no features/{t}.csv"
            )
        out[t] = np.loadtxt(fcsv, delimiter=",", dtype=np.float32, ndmin=2)
    return out


def _load_edges(
    path: Path, meta: dict
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    rels = [r[1] for r in meta["relations"]]
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    if _pick_format(path, meta, "edge_format", "edges.npz") == "npz":
        enpz = path / "edges.npz"
        if not enpz.is_file():
            raise ValueError(f"{path}: missing edges.npz")
        with np.load(enpz) as z:
            for rel in rels:
                ks, kd = f"{rel}__src", f"{rel}__dst"
                if ks not in z or kd not in z:
                    raise ValueError(
                        f"{enpz}: missing edge arrays for relation {rel!r}"
                    )
                out[rel] = (
                    np.asarray(z[ks], np.int64), np.asarray(z[kd], np.int64)
                )
        return out
    edir = path / "edges"
    for rel in rels:
        ecsv = edir / f"{rel}.csv"
        if not ecsv.is_file():
            raise ValueError(f"{path}: no edges.npz and no edges/{rel}.csv")
        pairs = np.loadtxt(ecsv, delimiter=",", skiprows=1, dtype=np.int64,
                           ndmin=2)
        if pairs.size == 0:
            out[rel] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        else:
            out[rel] = (pairs[:, 0].copy(), pairs[:, 1].copy())
    return out


def load_hetgraph(path: Union[str, "os.PathLike[str]"]) -> HetGraph:
    """Load a dump directory into a validated :class:`HetGraph`."""
    path = Path(path)
    meta = read_meta(path)
    lf = path / "labels.npy"
    if not lf.is_file():
        raise ValueError(f"{path}: missing labels.npy")
    g = HetGraph(
        node_types=tuple(meta["node_types"]),
        num_nodes={t: int(n) for t, n in meta["num_nodes"].items()},
        features=_load_features(path, meta),
        relations=tuple(tuple(r) for r in meta["relations"]),
        edges=_load_edges(path, meta),
        label_type=meta["label_type"],
        labels=np.load(lf),
        num_classes=int(meta["num_classes"]),
    )
    return g.validate()


# --------------------------------------------------------------------------
# unified resolution
# --------------------------------------------------------------------------


def resolve(
    dataset: DatasetSpec,
    scale: float = 1.0,
    seed: int = 0,
) -> Tuple[HetGraph, str, Optional[Dict[str, Sequence[str]]]]:
    """Turn any dataset spec into ``(graph, name, metapaths)``.

    ``dataset`` is a registry name (``scale``/``seed`` parameterize the
    generator), a path to an on-disk dump (``scale``/``seed`` ignored — the
    dump is what it is), or a ``HetGraph`` instance. The returned graph is
    always schema-validated; ``metapaths`` is the HAN metapath table when
    one is known (registry datasets ship one, dumps may carry one in
    meta.json), else ``None``.
    """
    if isinstance(dataset, HetGraph):
        return dataset.validate(), "hetgraph", None
    name = os.fspath(dataset)
    p = Path(name)
    is_dump = p.is_dir() and (p / "meta.json").is_file()
    if name in REGISTRY:
        if is_dump:
            # a dump directory shadowed by a registry name would silently
            # resolve to the synthetic generator — fail loud instead
            raise ValueError(
                f"dataset {name!r} is both a registered generator and an "
                f"on-disk dump directory; disambiguate with an explicit "
                f"path (e.g. {os.path.join('.', name)!r}) or rename one"
            )
        g = REGISTRY[name](scale=scale, seed=seed).validate()
        return g, name, synthetic.METAPATHS.get(name)
    if is_dump or p.is_dir():
        meta = read_meta(p)
        mps = meta.get("metapaths")
        return load_hetgraph(p), meta.get("name", p.name), mps
    raise ValueError(
        f"unknown dataset {dataset!r}: not a registered name "
        f"{available()} and not an on-disk dump directory"
    )

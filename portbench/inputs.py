"""What the benchmark hands the program and the reference alike: the graph
of a traffic mix (generated once per checkout, then read from
``build/portbench/graphs``), and the weights and features of a run, made on
the device from ``--seed``."""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from portbench import graphgen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"


def graph_key(spec: dict) -> str:
    """The cache key of a graph: its parameters and the generator's source."""
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    h.update((HERE / "graphgen.py").read_bytes())
    return h.hexdigest()[:16]


def load_graph(traffic: dict) -> Tuple[dict, str]:
    """The traffic mix's graph (``graphgen.make_graph``'s dict, arrays
    memory-mapped from the cache) and ``"hit"`` or ``"built"``."""
    spec = traffic["graph"]
    path = CACHE / "graphs" / f"{traffic['name']}-{graph_key(spec)}"
    status = "hit"
    if not (path / "graph.json").is_file():
        status = "built"
        g = graphgen.make_graph(spec)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=path.parent, prefix=".partial-"))
        try:
            for t, c in g["comm"].items():
                np.save(tmp / f"comm.{t}.npy", c)
            for rel, (s, d) in g["edges"].items():
                np.save(tmp / f"edges.{rel}.src.npy", s)
                np.save(tmp / f"edges.{rel}.dst.npy", d)
            meta = {k: g[k] for k in ("node_counts", "relations", "label_type", "num_classes", "feat_dims")}
            (tmp / "graph.json").write_text(json.dumps(meta))
            try:
                os.rename(tmp, path)
            except OSError:  # another process finished first: use its copy
                pass
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    meta = json.loads((path / "graph.json").read_text())
    meta["relations"] = [tuple(r) for r in meta["relations"]]
    meta["comm"] = {t: np.load(path / f"comm.{t}.npy", mmap_mode="r") for t in meta["node_counts"]}
    meta["edges"] = {
        rel: (np.load(path / f"edges.{rel}.src.npy", mmap_mode="r"),
              np.load(path / f"edges.{rel}.dst.npy", mmap_mode="r"))
        for _, rel, _ in meta["relations"]
    }
    return meta, status


def glorot_limit(name: str, shape) -> float:
    """Glorot-uniform's limit for a weight, fan-in the first dim and fan-out
    the product of the rest (a vector counts as one column); 0.1 for a bias
    (a name ending in ``.b``)."""
    if name.endswith(".b"):
        return 0.1
    fan_in = shape[0]
    fan_out = math.prod(shape[1:]) if len(shape) > 1 else 1
    return math.sqrt(6.0 / (fan_in + fan_out))


def make_inputs(shapes: Dict[str, tuple], graph: dict, feat_noise: float, seed: int, device,
                features: Dict[str, torch.Tensor] = None):
    """``(params, features)`` of a run, drawn on ``device`` from one
    generator seeded with ``seed``: every parameter from one uniform draw
    (names in sorted order), then per node type (graph order) its
    community centroids and its noise, features = centroid of the vertex's
    community + ``feat_noise`` · noise. ``features`` given: filled in place
    (the program's feature tensors), else made."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    u = torch.rand(total, generator=gen, device=device)
    params, off = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        lim = glorot_limit(n, shapes[n])
        params[n] = (u[off:off + size].view(shapes[n]) * (2 * lim) - lim).contiguous()
        off += size
    del u
    out = {} if features is None else features
    c = graph["num_classes"]
    for t, n in graph["node_counts"].items():
        f = graph["feat_dims"][t]
        centroids = torch.randn((c, f), generator=gen, device=device)
        x = out.get(t)
        if x is None:
            x = out[t] = torch.empty((n, f), dtype=torch.float32, device=device)
        x.normal_(generator=gen).mul_(feat_noise)
        comm = torch.from_numpy(np.array(graph["comm"][t], np.int64)).to(device)
        for i in range(0, n, 1 << 18):  # in blocks, so the gathered centroids stay small
            x[i:i + (1 << 18)].add_(centroids[comm[i:i + (1 << 18)]])
    return params, out

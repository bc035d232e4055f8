"""The plain reference's shared parts: semantic graphs worked out again from
the generator's edge lists, pruned neighbor aggregation over an edge list,
and the comparison that decides ``correct``.

Nothing here imports the program. Semantic graphs are edge lists
``(src, dst)``: ``src`` global vertex ids (types concatenated in the graph's
``node_counts`` order), ``dst`` local ids of the destination type. The
semantics are those the paper's SGB defines and the configuration states:
a metapath graph joins the relations of its chain on their shared vertex
(``_rev`` transposes one), drops repeated pairs, and adds a self-loop on
every vertex. A middle vertex whose pairs number more than ``cap_fanout``
(4096) contributes that many pairs drawn uniformly with replacement from a
seeded numpy generator: the SGB's sampling rule, replayed draw for draw
(numpy's ``default_rng(sgb_seed)``, left pair index then right, middle
vertices in ascending order, metapaths in the traffic file's order), since
the program's graph is that draw.

Pruned NA (the paper's Eq. 2 and its top-K): per destination, the
candidates are ranked by the head sum of θ_u* (summed head by head, left to
right); a destination with more than K candidates keeps the K highest, one
with K or fewer keeps all; α is the softmax over the kept candidates of
LeakyReLU(θ_u* + θ_*v) per head, and the output Σ α·h'[u].
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SLOPE = 0.2  # LeakyReLU's negative slope (GAT's)
CAP_FANOUT = 4096


# ---------------------------------------------------------------- graphs


def type_offsets(node_counts: Dict[str, int]) -> Dict[str, int]:
    off, out = 0, {}
    for t, n in node_counts.items():
        out[t] = off
        off += n
    return out


def _join(ab, bc, rng, cap: int):
    """A->C pairs of A->B and B->C joined on B, at most ``cap`` a B."""
    a, b1 = ab
    b2, c = bc
    o1 = np.argsort(b1, kind="stable")
    a, b1 = a[o1], b1[o1]
    o2 = np.argsort(b2, kind="stable")
    b2, c = b2[o2], c[o2]
    n_b = int(max(b1.max(initial=-1), b2.max(initial=-1))) + 1
    c1 = np.bincount(b1, minlength=n_b).astype(np.int64)
    c2 = np.bincount(b2, minlength=n_b).astype(np.int64)
    s1 = np.concatenate([[0], np.cumsum(c1)[:-1]])
    s2 = np.concatenate([[0], np.cumsum(c2)[:-1]])
    pairs = c1 * c2
    take = np.minimum(pairs, cap)
    total = int(take.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b_of = np.repeat(np.arange(n_b, dtype=np.int64), take)
    p = np.arange(total, dtype=np.int64) - np.repeat(np.concatenate([[0], np.cumsum(take)[:-1]]), take)
    width = np.maximum(c2[b_of], 1)
    li, ri = p // width, p % width
    over = np.flatnonzero(pairs[b_of] > cap)
    if over.size:
        li[over] = rng.integers(0, c1[b_of[over]])
        ri[over] = rng.integers(0, c2[b_of[over]])
    return a[s1[b_of] + li], c[s2[b_of] + ri]


def metapath_graphs(graph: dict, metapaths: Dict[str, Sequence[str]], sgb_seed: int,
                    cap: int = CAP_FANOUT) -> List[Tuple[str, str, np.ndarray, np.ndarray]]:
    """``(name, end type, global src, local dst)`` per metapath, in the
    table's order (see the module docstring)."""
    rng = np.random.default_rng(sgb_seed)
    offs = type_offsets(graph["node_counts"])
    rels = {name: (s, d) for s, name, d in graph["relations"]}

    def pairs(name):
        rev = name.endswith("_rev")
        base = name[:-4] if rev else name
        s, d = (np.asarray(a, np.int64) for a in graph["edges"][base])
        src_t, dst_t = rels[base]
        return ((d, s, dst_t, src_t) if rev else (s, d, src_t, dst_t))

    out = []
    for name, chain in metapaths.items():
        s, d, _, end_t = pairs(chain[0])
        for nxt in chain[1:]:
            s2, d2, _, end_t = pairs(nxt)
            s, d = _join((s, d), (s2, d2), rng, cap)
        n = graph["node_counts"][end_t]
        _, first = np.unique(s * (n + 1) + d, return_index=True)
        s, d = s[first], d[first]
        loops = np.arange(n, dtype=np.int64)
        out.append((name, end_t, np.concatenate([s, loops]) + offs[end_t], np.concatenate([d, loops])))
    return out


# ---------------------------------------------------------------- NA


class Graph:
    """One semantic graph on the device, its edges grouped by destination."""

    def __init__(self, name: str, dst_type: str, src: np.ndarray, dst: np.ndarray,
                 n_dst: int, device):
        self.name, self.dst_type, self.n_dst = name, dst_type, int(n_dst)
        s = torch.from_numpy(np.array(src, np.int64)).to(device)
        d = torch.from_numpy(np.array(dst, np.int64)).to(device)
        order = torch.argsort(d, stable=True)
        self.src, self.dst = s[order], d[order]
        self.count = torch.bincount(self.dst, minlength=self.n_dst)
        self.start = torch.cumsum(self.count, 0) - self.count

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def head_sum(th: torch.Tensor) -> torch.Tensor:
    """Σ over the last (head) axis, head by head, left to right."""
    out = th[..., 0]
    for i in range(1, th.shape[-1]):
        out = out + th[..., i]
    return out


def topk_edges(g: Graph, rank: torch.Tensor, k: Optional[int]):
    """The kept edges and each destination's margin.

    ``rank`` (E,) per edge. Returns ``(kept edge index, margin (n_dst,))``:
    the margin of a destination with more than ``k`` candidates is the
    least gap between a kept and a dropped candidate of another source
    vertex (how far the ranking may move before another set is kept);
    ``inf`` elsewhere."""
    n, e = g.n_dst, g.num_edges
    margin = torch.full((n,), math.inf, dtype=torch.float64, device=rank.device)
    if k is None:
        return torch.arange(e, device=rank.device), margin
    o1 = torch.argsort(rank, descending=True, stable=True)
    order = o1[torch.argsort(g.dst[o1], stable=True)]
    pos = torch.arange(e, device=rank.device) - g.start[g.dst[order]]
    kept = order[pos < k]
    over = torch.nonzero(g.count > k).squeeze(1)
    if over.numel():
        base = g.start[over]
        cnt = g.count[over]
        s = rank[order].double()
        ids = g.src[order]

        def at(j):  # sorted slot j of each over-full row (clamped, masked)
            ok = j < cnt
            jj = torch.where(ok, base + j, base)
            return s[jj], ids[jj], ok

        sk1, ik1, _ = at(torch.full_like(cnt, k - 1))
        sk, ik, _ = at(torch.full_like(cnt, k))
        gap = torch.where(ik1 != ik, sk1 - sk, torch.full_like(sk, math.inf))
        # a source kept twice (a self-loop beside the same edge) straddling
        # the cut: the next distinct neighbours on each side decide
        skm, ikm, _ = at(torch.full_like(cnt, k - 2))
        skp, ikp, okp = at(torch.full_like(cnt, k + 1))
        dup = ik1 == ik
        alt = torch.minimum(
            torch.where(ikm != ik, skm - sk, torch.full_like(sk, math.inf)),
            torch.where(okp & (ikp != ik1), sk1 - skp, torch.full_like(sk, math.inf)),
        )
        margin[over] = torch.where(dup, alt, gap)
    return kept, margin


def pruned_na(h: torch.Tensor, theta_src: torch.Tensor, theta_dst: torch.Tensor, g: Graph,
              k: Optional[int], slope: float = SLOPE):
    """Pruned NA of one semantic graph -> ``(out (n_dst, H, dh), kept edge
    index, margin)``. ``h`` (N, H, dh) the global projected table,
    ``theta_src`` (N, H), ``theta_dst`` (n_dst, H)."""
    rank = head_sum(theta_src)[g.src]
    kept, margin = topk_edges(g, rank, k)
    src, dst = g.src[kept], g.dst[kept]
    e = F.leaky_relu(theta_src[src] + theta_dst[dst], slope)  # (E_k, H)
    heads = e.shape[1]
    idx = dst[:, None].expand(-1, heads)
    mx = torch.full((g.n_dst, heads), -math.inf, dtype=e.dtype, device=e.device)
    mx = mx.scatter_reduce(0, idx, e, reduce="amax", include_self=True)
    p = torch.exp(e - mx[dst])
    den = torch.zeros((g.n_dst, heads), dtype=e.dtype, device=e.device).index_add_(0, dst, p)
    alpha = p / den[dst]
    out = torch.zeros((g.n_dst,) + tuple(h.shape[1:]), dtype=h.dtype, device=h.device)
    for c in range(0, kept.numel(), 1 << 21):  # blocks of edges, so the product fits
        sl = slice(c, c + (1 << 21))
        out.index_add_(0, dst[sl], alpha[sl, :, None] * h[src[sl]])
    return out, kept, margin


def theta(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """θ (N, H) = Σ_d h'[n, h, d] a[h, d] (Eq. 2's decomposition)."""
    return torch.einsum("nhd,hd->nh", h, a).contiguous()


@contextlib.contextmanager
def precision(mode: str):
    """``"float32"``: float32 products, TF32 off (the configuration's);
    ``"tf32"``: the control, float32 products rounded through TF32."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------- record


class Record:
    """What the reference learns of each NA while it runs: the work it
    needs (for the bound and the model FLOPs) and which rows hinge on a
    near tie.

    A destination's pruning is a near tie when its margin (``topk_edges``)
    is under ``margin_eps`` times the RMS of that graph's ranking scores:
    float32 rounding of the same sums may keep another set there. A row is
    *tied* when its own pruning is a near tie or any vertex it reads (its
    candidates, itself) was tied at the layer before: its answer may
    differ from the reference's by another, equally valid choice.
    ``margin_eps`` may be a sequence: each value is followed apart, and
    ``tied_rows`` gives one mask a value."""

    def __init__(self, node_counts: Dict[str, int], margin_eps):
        self.counts = dict(node_counts)
        self.offs = type_offsets(node_counts)
        self.single = not isinstance(margin_eps, (list, tuple))
        self.eps = [float(margin_eps)] if self.single else [float(e) for e in margin_eps]
        self.entries: List[dict] = []
        self._tied_in: Optional[torch.Tensor] = None  # (n_eps, N) bool, a layer's input
        self._tied_out: Dict[str, torch.Tensor] = {}

    def na(self, layer: int, g: Graph, kept: torch.Tensor, margin: torch.Tensor,
           theta_src: torch.Tensor, h_shape) -> None:
        from portbench import yardstick

        dev = kept.device
        if self._tied_in is None:
            n_total = sum(self.counts.values())
            self._tied_in = torch.zeros((len(self.eps), n_total), dtype=torch.bool, device=dev)
        rank = head_sum(theta_src)[g.src].double()
        rms = float(rank.square().mean().sqrt()) if rank.numel() else 0.0
        eps = torch.tensor(self.eps, dtype=torch.float64, device=dev)[:, None]
        near = margin[None, :] < eps * max(rms, 1e-30)
        o = self.offs[g.dst_type]
        tied = near | self._tied_in[:, o: o + g.n_dst]
        for i in range(len(self.eps)):
            tied[i, g.dst[self._tied_in[i, g.src]]] = True
        prev = self._tied_out.get(g.dst_type)
        self._tied_out[g.dst_type] = tied if prev is None else prev | tied
        self.entries.append({
            "layer": layer, "graph": g.name, "targets": g.n_dst, "valid_slots": g.num_edges,
            "kept_slots": int(kept.numel()), "near_ties": [int(x) for x in near.sum(dim=1)],
            "bound": yardstick.na_bound(g.src, g.src[kept], g.n_dst, h_shape),
        })

    def layer_done(self) -> None:
        """Close a layer: each type's rows are tied where any graph into it
        tied them, or where they were tied already."""
        nxt = self._tied_in.clone()
        for t, tied in self._tied_out.items():
            nxt[:, self.offs[t]: self.offs[t] + self.counts[t]] |= tied
        self._tied_in, self._tied_out = nxt, {}

    def tied_rows(self, t: str) -> torch.Tensor:
        """The rows of type ``t`` whose answer hinges on a near tie, (N_t,)
        bool, or (n_eps, N_t) for a sequence of ``margin_eps`` (call after
        the last ``layer_done``)."""
        rows = self._tied_in[:, self.offs[t]: self.offs[t] + self.counts[t]]
        return rows[0] if self.single else rows

    def kept_slots(self) -> int:
        return sum(e["kept_slots"] for e in self.entries)


# ---------------------------------------------------------------- compare


def compare(got: torch.Tensor, ref: torch.Tensor, tied: torch.Tensor) -> Dict[str, float]:
    """The numbers that decide ``correct``, of the program's logits ``got``
    against the reference's ``ref`` (both (T, C)): each row's error is its
    largest absolute difference over the RMS of all of ``ref``.

    ``err_p99``: the 99th percentile of the row errors (every row);
    ``err_max_untied``: the largest row error among rows that hinge on no
    near tie; ``err_max``: the largest row error of all, and
    ``tied_share``: the share of tied rows (both reported, not compared)."""
    got = got.to(ref.device, torch.float64)
    ref = ref.double()
    scale = float(ref.square().mean().sqrt())
    err = (got - ref).abs().amax(dim=1) / max(scale, 1e-30)
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, math.inf))
    untied = err[~tied]
    return {
        "err_p99": float(torch.quantile(err.float(), 0.99)) if err.numel() else 0.0,
        "err_max_untied": float(untied.max()) if untied.numel() else 0.0,
        "err_max": float(err.max()) if err.numel() else 0.0,
        "tied_share": float(tied.double().mean()) if tied.numel() else 0.0,
    }

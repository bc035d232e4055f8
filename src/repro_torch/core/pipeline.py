"""End-to-end HGNN task assembly: dataset → SGB → model → GraphBatch.

``prepare()`` is table-driven over the model registry
(``repro_torch.core.models.MODELS``): each architecture names its SGB kind
and factory. The dataset is a registry name, an on-disk dump directory or
a ``HetGraph`` (``data.datasets.resolve``), and the SGB goes through the
artifact cache (``data.sgb_cache.build_or_load``). The returned
``HGNNTask`` serves inference through ``task.compile(flow)``, an
:class:`~repro_torch.core.session.InferenceSession` cached per flow,
device, parameter names, shapes and dtypes and ``donate_params``, and trains through
``train_hgnn``: full-batch cross-entropy on the train split and AdamW, one
:class:`TrainStep` cached per (flow, lr, weight decay), which on a CUDA
task is one captured CUDA graph (the reference's jitted step).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hetgraph
from repro_torch.core.batch import GraphBatch, ModelSpec
from repro_torch.core.flows import FlowConfig
from repro_torch.core.models import get_entry
from repro_torch.core.session import InferenceSession, param_spec
from repro_torch.data import datasets, sgb_cache
from repro_torch.optim import Optimizer, adamw


@dataclasses.dataclass
class HGNNTask:
    name: str
    model_name: str
    model: object
    graph: hetgraph.HetGraph
    batch: GraphBatch
    spec: ModelSpec
    params: Dict[str, torch.Tensor]
    labels: torch.Tensor
    splits: Dict[str, np.ndarray]
    sgs: list  # semantic graphs driving NA
    device: torch.device
    # the build arguments that produced ``sgs``: what merging a streamed
    # delta into the layouts, or a rebuild for bit-parity, must replay
    sgb_kind: str = ""
    sgb_args: dict = dataclasses.field(default_factory=dict)
    metapaths: Optional[Dict[str, Sequence[str]]] = None
    _sessions: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    _steps: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    _warned_logits: bool = dataclasses.field(default=False, repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return int(sum(sg.num_edges for sg in self.sgs))

    def logits(self, params, flow: FlowConfig = FlowConfig()) -> torch.Tensor:
        """DEPRECATED shim over ``model.apply(params, batch, flow)``, as the
        reference keeps it: bit for bit ``model.apply``, with one
        ``DeprecationWarning`` per task. New code calls
        ``task.model.apply(params, task.batch, flow)`` for one forward or
        ``task.compile(flow)`` for repeated inference."""
        if not self._warned_logits:
            self._warned_logits = True
            warnings.warn(
                "HGNNTask.logits is deprecated: use "
                "task.model.apply(params, task.batch, flow) or "
                "task.compile(flow)",
                DeprecationWarning,
                stacklevel=2,
            )
        return self.model.apply(params, self.batch, flow)

    def compile(
        self, flow: FlowConfig = FlowConfig(), params=None, donate_params: bool = False
    ) -> InferenceSession:
        """The serving entry: one session per (flow, device, parameter
        names with their shapes and dtypes, ``donate_params``), cached on the
        task, so repeated calls (``accuracy`` over splits, a serving loop)
        share one program. ``params`` only gives the example the session is
        built against (default: the task's own); ``donate_params`` marks a
        session for weight streaming (``InferenceSession``), a second handle
        on the program of the session that differs only in it, where that
        one is cached already. The reference
        also keys on the mesh, which waits for the sharded layouts (ROADMAP
        §1 item 6)."""
        if params is None:
            params = self.params
        key = (flow, self.device, param_spec(params), bool(donate_params))
        sess = self._sessions.get(key)
        if sess is None:
            twin = self._sessions.get(key[:3] + (not key[3],))
            if twin is not None:
                sess = twin.with_donation(donate_params)
            else:
                sess = InferenceSession(
                    self.model, self.batch, flow, params=params, donate_params=donate_params
                )
            self._sessions[key] = sess
        return sess

    def _train_step(self, flow: FlowConfig, lr: float, weight_decay: float = 1e-4) -> "TrainStep":
        """The training step for (flow, lr, weight_decay), built once and
        cached on the task, so repeated ``train_hgnn`` calls (a longer
        schedule, a re-run) reuse one program. ``fused_kernel`` raises
        ``ValueError``: its CUDA kernels have no backward, in either
        package."""
        if flow.flow == "fused_kernel":
            raise ValueError(
                "flow 'fused_kernel' cannot train: its kernels have no backward; "
                "train under 'staged', 'staged_pruned' or 'fused'"
            )
        key = (flow, float(lr), float(weight_decay))
        step = self._steps.get(key)
        if step is None:
            step = TrainStep(self, flow, adamw(lr=lr, weight_decay=weight_decay))
            self._steps[key] = step
        return step


def _state_tensors(params, state) -> list:
    """A training step's state as one list: the params, the moments and
    the step counter, in the params' name order."""
    names = list(params)
    return (
        [params[n] for n in names] + [state.mu[n] for n in names]
        + [state.nu[n] for n in names] + [state.step]
    )


class TrainStep:
    """One full-batch training step of a task under one flow: the mean
    negative log-softmax of the train split's rows, its gradients by
    ``torch.autograd.grad`` (zeros for a parameter the loss does not use,
    as JAX gives), then ``opt.update``.

    The step holds the parameters it trains and their optimizer state,
    the step counter a 0-d device tensor, and updates them in place. On a
    CUDA task the whole step (forward, backward, clip and AdamW) is one
    CUDA graph, captured at construction into a pool of its own after one
    eager step on a side stream (which fills every lazy device cache); a
    call replays it and returns the static loss tensor, valid until the
    next call. A capture that fails raises; the step never gives way to
    the eager one. On the CPU a call runs the step eagerly.

    ``reset(params)`` loads parameters and zeroes the optimizer state;
    ``params()`` returns copies of the parameters as they stand.
    """

    def __init__(self, task: HGNNTask, flow: FlowConfig, opt: Optimizer):
        self._task, self._flow, self._opt = task, flow, opt
        self._rows = torch.from_numpy(task.splits["train"].astype(np.int64)).to(task.device)
        self._labels = task.labels[self._rows][:, None]
        with torch.no_grad():
            self._params = {n: t.detach().clone().requires_grad_() for n, t in task.params.items()}
        self._state = opt.init(self._params)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if task.device.type == "cuda":
            self._capture()
        self.reset(task.params)

    def _loss(self) -> torch.Tensor:
        logits = self._task.model.apply(self._params, self._task.batch, self._flow)[self._rows]
        return -torch.log_softmax(logits, dim=-1).gather(1, self._labels).mean()

    def eager(self) -> torch.Tensor:
        """One step run eagerly, operator by operator, on the held state:
        what a call runs on the CPU, and the yardstick of the captured
        step on a card. Returns the loss."""
        names = list(self._params)
        loss = self._loss()
        grads = torch.autograd.grad(
            loss, [self._params[n] for n in names], allow_unused=True, materialize_grads=True
        )
        with torch.no_grad():
            params, state = self._opt.update(dict(zip(names, grads)), self._state, self._params)
            torch._foreach_copy_(_state_tensors(self._params, self._state), _state_tensors(params, state))
        return loss.detach()

    def _capture(self) -> None:
        dev = self._task.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loss = self.eager()
        self._graph, self._loss_out = graph, loss

    def reset(self, params: Mapping[str, torch.Tensor]) -> None:
        """Load ``params`` (the names the step was built with) and zero the
        moments and the step counter."""
        with torch.no_grad():
            held = _state_tensors(self._params, self._state)
            n = len(self._params)
            torch._foreach_copy_(held[:n], [params[name] for name in self._params])
            torch._foreach_zero_(held[n:])

    def __call__(self) -> torch.Tensor:
        """One step; the 0-d loss of the parameters it started from."""
        if self._graph is None:
            return self.eager()
        self._graph.replay()
        return self._loss_out

    @property
    def captured(self) -> bool:
        """Whether calls replay a captured CUDA graph (a CUDA task)."""
        return self._graph is not None

    def params(self) -> Dict[str, torch.Tensor]:
        """Copies of the parameters as they stand: plain tensors that no
        later step changes."""
        with torch.no_grad():
            return {n: t.detach().clone() for n, t in self._params.items()}


def _splits(n: int, seed: int = 0):
    """60/20/20 random split (the reference's, draw for draw). For
    ``n >= 3`` every split is non-empty; the three splits always form a
    disjoint union of ``range(n)``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_tr, n_va = int(0.6 * n), int(0.2 * n)
    if n >= 3:
        n_va = max(1, n_va)
        n_tr = max(1, min(n_tr, n - n_va - 1))
    out = {
        "train": perm[:n_tr],
        "val": perm[n_tr: n_tr + n_va],
        "test": perm[n_tr + n_va:],
    }
    cover = np.sort(np.concatenate(list(out.values())))
    if not np.array_equal(cover, np.arange(n)):
        raise AssertionError("splits must partition range(n)")
    return out


def prepare(
    model_name: str,
    dataset: datasets.DatasetSpec,
    scale: float = 0.1,
    max_degree: Optional[int] = 256,
    seed: int = 0,
    bucket_sizes: Union[Sequence[int], str, None] = hetgraph.DEFAULT_BUCKET_SIZES,
    sgb_cache_dir: Union[str, "os.PathLike[str]", None] = None,
    metapaths: Optional[Dict[str, Sequence[str]]] = None,
    device="cuda",
) -> HGNNTask:
    """Assemble dataset → SGB → model on ``device``.

    ``dataset`` is a registry name (generated with ``scale``/``seed``), a
    path to an on-disk dump directory or a ``HetGraph``
    (``datasets.resolve``); the graph is schema-validated either way.
    ``metapaths`` overrides the dataset's HAN metapath table (registry
    datasets ship one, dumps may carry one in meta.json, an in-memory
    ``HetGraph`` has none). The model's registry entry names its SGB kind:
    metapath graphs (HAN), one graph per relation (RGAT) or one union
    graph per node type (Simple-HGN). ``bucket_sizes`` selects the SGB
    layout: a capacity list gives the degree-bucketed build (the default),
    ``"auto"`` each graph's capacities from its own degree histogram
    (``hetgraph.autotune_bucket_sizes``), ``None`` the flat ``(T, D_max)``
    one. ``sgb_cache_dir`` (or ``$REPRO_SGB_CACHE``) loads a bucketed SGB
    from the content-addressed artifact cache, or builds and saves it
    there (``sgb_cache.build_or_load``). The model's parameters are drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed`` and then
    moved, so the same seed gives the same weights on every device.
    ``device`` defaults to the GPU and raises without one; pass
    ``device="cpu"`` for the CPU. The reference's ``shards=`` waits for
    the sharded layouts (ROADMAP §1 item 6).
    """
    dev = resolve_device(device)
    entry = get_entry(model_name)
    g, ds_name, mps = datasets.resolve(dataset, scale=scale, seed=seed)
    if metapaths is not None:
        mps = metapaths
    sgb_kw = dict(
        max_degree=max_degree, seed=seed, bucket_sizes=bucket_sizes,
        cache_dir=sgb_cache_dir,
    )
    if entry.needs_metapaths:
        if not mps:
            raise ValueError(
                f"model {model_name!r} needs metapaths for dataset "
                f"{ds_name!r}: registry datasets define them; on-disk dumps "
                "carry them in meta.json"
            )
        built, _ = sgb_cache.build_or_load(g, entry.sgb_kind, metapaths=mps, **sgb_kw)
    else:
        built, _ = sgb_cache.build_or_load(g, entry.sgb_kind, **sgb_kw)
    # a union build is keyed by destination type, in node_types order
    sgs = list(built.values()) if isinstance(built, dict) else list(built)
    batch = GraphBatch.from_graph(g, sgs, dev)
    spec = ModelSpec.from_graph(g, sgs)
    model = entry.factory(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    return HGNNTask(
        name=f"{model_name}/{ds_name}",
        model_name=model_name,
        model=model,
        graph=g,
        batch=batch,
        spec=spec,
        params=dict(model.named_parameters()),
        labels=torch.from_numpy(g.labels.astype(np.int64)).to(dev),
        splits=_splits(g.num_nodes[g.label_type], seed),
        sgs=sgs,
        device=dev,
        sgb_kind=entry.sgb_kind,
        sgb_args=dict(max_degree=max_degree, seed=seed, bucket_sizes=bucket_sizes),
        metapaths=dict(mps) if mps else None,
    )


def train_hgnn(
    task: HGNNTask,
    steps: int = 200,
    lr: float = 5e-3,
    flow: FlowConfig = FlowConfig(),
    log_every: int = 0,
) -> Dict[str, torch.Tensor]:
    """Full-batch node-classification training, as the reference's: AdamW
    (weight decay 1e-4, gradients clipped to global norm 1) from
    ``task.params``, which it never writes to. Returns the trained
    parameters as a fresh mapping of plain tensors, which
    ``task.compile(flow, params=...)`` and ``accuracy`` take. The step is
    cached on the task per (flow, lr), so a second call reuses its
    program. With ``log_every`` it prints the reference's ``step … loss …``
    lines (the only time it reads the loss back)."""
    step = task._train_step(flow, lr)
    step.reset(task.params)
    for i in range(steps):
        loss = step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"  step {i:4d} loss {float(loss):.4f}")
    return step.params()


def accuracy(task: HGNNTask, params, flow: FlowConfig = FlowConfig(), split="test") -> float:
    """Split accuracy through the task's cached session for ``params``
    (one session per flow and parameter names, shapes and dtypes)."""
    idx = torch.from_numpy(task.splits[split].astype(np.int64)).to(task.device)
    pred = task.compile(flow, params=params)(params)[idx].argmax(-1)
    return float((pred == task.labels[idx]).float().mean())

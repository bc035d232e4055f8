"""Checkpoints with atomic commits and an asynchronous write (the
reference's ``repro/checkpoint/manager.py``).

Layout::

    <dir>/step_<n>/
        manifest.json   — step, time, the names, shapes and dtypes
        arrays.npz      — one array per name
        COMMITTED       — written last, before the rename that publishes

A step is written to ``<dir>/.tmp_step_<n>_<pid>`` and renamed to
``step_<n>``; ``latest_step`` sees only directories with ``COMMITTED``, so
a crash mid-save is never resumed from. After each write the oldest
committed steps past ``keep`` are removed.

The state is a flat name → tensor mapping (:func:`flatten_train_state`
lays out parameters and an optimizer state so). ``save`` snapshots every
tensor to host memory before it returns, a synchronous copy from the
device: the caller's next training step makes new tensors and drops these,
so only the write may run behind (``blocking=False``: one writer thread,
at most one write in flight). numpy has no bfloat16: a bfloat16 tensor is
stored as its 16-bit pattern (``uint16``), with ``bfloat16`` in the
manifest, and restored bit for bit.

A state placed on a device mesh (DTensor leaves) is saved whole: each
leaf's ``full_tensor()`` (a collective, so every rank calls ``save``), and
only global rank 0 writes it, once. ``restore(..., shardings=)`` places
each leaf on a mesh again (``distribute_tensor``, each rank keeping its
chunk), which may differ from the one it was saved from: the elastic
rescale of ``runtime/trainer.py``'s ``restore_for_mesh``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.npz import mmap_views
from repro_torch.optim.adafactor import AdafactorState, FactoredSlot
from repro_torch.optim.adamw import AdamWState

_SLOT_PARTS = ("row", "col", "full")


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of ``t`` (a DTensor's whole value) in host memory as numpy,
    and its dtype's name."""
    if type(t).__name__ == "DTensor":
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_write: Dict[str, float] = {}  # step, bytes, snapshot_s, write_s of the last write

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Mapping[str, torch.Tensor], blocking: bool = True):
        """Snapshot ``state`` to host memory now; write it now
        (``blocking``) or on the writer thread. A placed state is gathered
        on every rank and written by global rank 0 alone; a blocking save
        then waits for every rank (a barrier), so no rank reads the step
        before it is committed."""
        t0 = time.perf_counter()
        placed = any(type(t).__name__ == "DTensor" for t in state.values())
        host = {name: _to_host(t) for name, t in state.items()}
        snapshot_s = time.perf_counter() - t0
        self.wait()  # one in-flight save at a time
        if placed:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                if blocking:
                    dist.barrier()
                return

        def write():
            t1 = time.perf_counter()
            tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **{name: a for name, (a, _) in host.items()})
            manifest = {
                "step": step,
                "time": time.time(),
                "names": list(host),
                "shapes": [list(a.shape) for a, _ in host.values()],
                "dtypes": [dtype for _, dtype in host.values()],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMITTED").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic on posix
            self._gc()
            self.last_write = {
                "step": step, "bytes": sum(p.stat().st_size for p in final.iterdir()),
                "snapshot_s": snapshot_s, "write_s": time.perf_counter() - t1,
            }

        if blocking:
            write()
            if placed:
                import torch.distributed as dist

                dist.barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, target: Mapping[str, torch.Tensor],
                shardings: Optional[Mapping[str, object]] = None) -> Dict[str, torch.Tensor]:
        """The state saved at ``step`` as ``target`` names, shapes, dtypes
        and places it; with ``shardings`` (a ``sharding.Sharding`` by name)
        each leaf placed on its mesh instead (a DTensor, this rank holding
        its chunk). A name missing or added, or a shape changed, raises
        ``ValueError``."""
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        if set(manifest["names"]) != set(target):
            missing = sorted(set(target) - set(manifest["names"]))
            extra = sorted(set(manifest["names"]) - set(target))
            raise ValueError(f"state structure changed: missing {missing}, unexpected {extra}")
        dtypes = dict(zip(manifest["names"], manifest["dtypes"]))
        out = {}
        data = mmap_views(path / "arrays.npz")
        if data is None:
            raise ValueError(f"{path / 'arrays.npz'} is not an npz of uncompressed members, as save writes")
        for name, spec in target.items():
            arr = data[name]
            if list(arr.shape) != list(spec.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != target {tuple(spec.shape)}")
            t = _from_host(arr, dtypes[name])
            sh = None if shardings is None else shardings[name]
            if sh is None:
                out[name] = t.to(spec.device, spec.dtype)
            else:
                out[name] = sharding.place(t.to(spec.dtype), sh)
        return out


def flatten_train_state(params: Mapping[str, torch.Tensor], opt_state) -> Dict[str, torch.Tensor]:
    """Parameters and an AdamW or Adafactor state as one flat mapping:
    ``params.<name>``, ``opt.step``, ``opt.mu.<name>`` / ``opt.nu.<name>``
    or ``opt.slots.<name>.row`` / ``.col`` / ``.full`` (the parts that are
    set)."""
    out = {f"params.{n}": t for n, t in params.items()}
    out["opt.step"] = opt_state.step
    if isinstance(opt_state, AdamWState):
        out.update({f"opt.mu.{n}": t for n, t in opt_state.mu.items()})
        out.update({f"opt.nu.{n}": t for n, t in opt_state.nu.items()})
    else:
        for n, slot in opt_state.slots.items():
            out.update({f"opt.slots.{n}.{part}": getattr(slot, part) for part in _SLOT_PARTS
                        if getattr(slot, part) is not None})
    return out


def unflatten_train_state(flat: Mapping[str, torch.Tensor], opt_like):
    """(params, opt_state) from :func:`flatten_train_state`'s layout;
    ``opt_like`` gives the optimizer state's type and slots."""
    params = {n[len("params."):]: t for n, t in flat.items() if n.startswith("params.")}
    step = flat["opt.step"]
    if isinstance(opt_like, AdamWState):
        return params, AdamWState(step, {n: flat[f"opt.mu.{n}"] for n in opt_like.mu},
                                  {n: flat[f"opt.nu.{n}"] for n in opt_like.nu})
    slots = {n: FactoredSlot(*(None if getattr(slot, part) is None else flat[f"opt.slots.{n}.{part}"]
                               for part in _SLOT_PARTS))
             for n, slot in opt_like.slots.items()}
    return params, AdafactorState(step, slots)

"""Fault-tolerant training loop (the reference's
``repro/runtime/trainer.py``).

  * auto-resume: on start, restore the latest COMMITTED checkpoint; the
    data pipeline skips ahead deterministically (batch = f(seed, step)).
  * periodic asynchronous checkpoints (the snapshot is taken before
    ``save`` returns; the disk write runs behind the next steps).
  * step-level retry: a step that raises is re-run from the last good
    state, which the pure step (``launch/steps.py``) never writes; after the
    last retry the state is saved (blocking) and the error raised.
  * straggler watch: a rolling-p50 timing monitor with a response hook.

Each committed step's parameters are handed to the trainer's ``LM``
(``load_params``, which shares the tensors), so serving it reads the
trained weights. ``restore_for_mesh`` is the elastic rescale: the latest
checkpoint, from any mesh or none, placed on another mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager, flatten_train_state, unflatten_train_state
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import LM
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 20
    keep: int = 3
    seed: int = 0
    max_retries: int = 2
    log_every: int = 10


class Trainer:
    def __init__(self, model_cfg: ModelConfig, tcfg: TrainConfig, device="cuda"):
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = LM(model_cfg, self.device)
        self.opt = steps_lib.make_optimizer(model_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.pipeline = TokenPipeline(
            vocab_size=model_cfg.vocab_size,
            seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch,
            seed=tcfg.seed,
        )
        self.monitor = StragglerMonitor(
            on_straggler=lambda s, dt, p50: print(
                f"[straggler] step {s}: {dt:.3f}s vs p50 {p50:.3f}s — "
                f"flagging host for reassignment", flush=True
            )
        )
        self.step_fn = steps_lib.make_train_step(model_cfg)

    # ------------------------------------------------------------ state
    def init_state(self):
        """(params, opt_state): the LM's seeded init from a generator seeded
        ``tcfg.seed`` on the trainer's device (``LM.reset_parameters``), and
        the optimizer's zero state."""
        self.model.reset_parameters(torch.Generator(self.device).manual_seed(self.tcfg.seed))
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        return params, self.opt.init(params)

    def restore_or_init(self):
        params, opt_state = self.init_state()
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt_state, 0
        flat = self.ckpt.restore(latest, flatten_train_state(params, opt_state))
        params, opt_state = unflatten_train_state(flat, opt_state)
        self.model.load_params(params)
        print(f"[trainer] resumed from step {latest}", flush=True)
        return params, opt_state, latest

    def restore_for_mesh(self, mesh, shardings):
        """Elastic rescale: the latest checkpoint placed on ``mesh`` ->
        ((params, opt_state), its step). ``shardings`` is ``(parameter
        shardings, optimizer-state shardings)`` built against ``mesh``
        (``launch/steps.py``'s ``params_shardings``). Every rank of
        ``mesh`` calls it. Raises ``FileNotFoundError`` without a
        checkpoint."""
        latest = self.ckpt.latest_step()
        if latest is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.ckpt.dir} to rescale from")
        params, opt_state = steps_lib.state_specs(self.cfg, with_opt=True)  # names, shapes, dtypes (meta)
        flat = self.ckpt.restore(latest, flatten_train_state(params, opt_state),
                                 shardings=flatten_train_state(*shardings))
        return unflatten_train_state(flat, opt_state), latest

    # ------------------------------------------------------------- loop
    def run(self, context_fn: Optional[Callable[[int], torch.Tensor]] = None):
        """Train from the latest checkpoint (or the init) to ``tcfg.steps``;
        returns (params, opt_state, the losses of the steps run).
        ``context_fn(step)`` gives a "vlm" or "audio" LM's context."""
        params, opt_state, start = self.restore_or_init()
        losses = []
        step = start
        while step < self.tcfg.steps:
            batch = self.pipeline.batch(step, self.device)  # deterministic skip-ahead
            if context_fn is not None:
                batch["context"] = context_fn(step)
            self.monitor.step_start()
            for attempt in range(self.tcfg.max_retries + 1):
                try:
                    new_params, new_opt, loss = self.step_fn(params, opt_state, batch)
                    loss = float(loss)  # waits for the step's device work
                    break
                except Exception as e:  # transient failure -> retry from the last good state
                    if attempt == self.tcfg.max_retries:
                        # final failure: checkpoint what we have and re-raise
                        self.ckpt.save(step, flatten_train_state(params, opt_state), blocking=True)
                        raise
                    print(f"[trainer] step {step} attempt {attempt} failed: {e}; retrying", flush=True)
            params, opt_state = new_params, new_opt
            self.model.load_params(params)
            dt = self.monitor.step_end(step)
            losses.append(loss)
            step += 1
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
            if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                self.ckpt.save(step, flatten_train_state(params, opt_state), blocking=False)
        self.ckpt.wait()
        return params, opt_state, losses

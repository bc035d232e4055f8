"""Training launcher (the reference's ``repro/launch/train.py``), on one
device: the card unless ``--device cpu``. Fault tolerance lives in
``repro_torch.runtime.Trainer``: auto-resume from the latest committed
checkpoint, asynchronous saves, step retries, straggler watch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
        --device cpu --steps 50 --ckpt-dir /tmp/ckpt

A "vlm" or "audio" arch trains on a stub context, (global batch,
``ctx_len``, d_model) standard normals drawn per step from a generator
seeded with the step (the reference draws the same shape from
``jax.random``, whose values torch cannot reproduce).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.runtime import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    ctx_fn = None
    if cfg.num_img_tokens or cfg.num_audio_frames:
        n = cfg.num_img_tokens or cfg.num_audio_frames

        def ctx_fn(step):
            gen = torch.Generator(trainer.device).manual_seed(step)
            return torch.randn((args.global_batch, n, cfg.d_model), generator=gen, device=trainer.device)

    _, _, losses = trainer.run(context_fn=ctx_fn)
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} last loss {losses[-1]:.4f}")
    else:
        print(f"[train] done: the checkpoint is at step {args.steps} already")


if __name__ == "__main__":
    main()

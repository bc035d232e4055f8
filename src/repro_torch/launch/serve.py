"""Serving launcher: batched prefill + greedy decode with ADE pruning.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --batch 4 --prompt-len 3072 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
        --prune-k 256

``--arch`` takes any of the ten archs (``repro_torch.configs.ARCHS``, by
name or alias).

Weights are seeded random (``--seed``), drawn on the device; prompts, and
the stub context of a "vlm" or "audio" arch (image embeddings
(B, num_img_tokens, d_model) or audio frames (B, num_audio_frames,
d_model), standard normal, as the reference launcher draws them), come
from a ``torch.Generator`` (they do not match the reference launcher's
``jax.random`` draws). Runs on the GPU unless ``--device cpu``. On the GPU
the decode steps replay one captured CUDA graph (``LM.compile_decode``,
captured at the first step); on the CPU they run eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prune-k", type=int, default=None,
                    help="override ADE top-K KV pruning")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.prune_k is not None:
        cfg = dataclasses.replace(cfg, attn_prune_k=args.prune_k)
    model = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(args.seed))

    b, t = args.batch, args.prompt_len
    max_len = t + args.gen
    gen = torch.Generator(dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
    ctx = (torch.randn((b, model.ctx_len, cfg.d_model), generator=gen, device=dev)
           if model.ctx_len else None)

    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_len=max_len, context=ctx)
    sync(dev)
    t_prefill = time.perf_counter() - t0

    # one captured program per step on the card, eager on the CPU; argmax
    # stays outside the step, as in the reference
    step = model.compile_decode(cache)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for pos in range(t, max_len):
        logits = step(tok, pos)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    sync(dev)
    t_dec = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    print(f"[serve] arch={cfg.name} prune_k={cfg.attn_prune_k}")
    print(f"[serve] prefill {t}tok x{b}: {t_prefill*1e3:.1f} ms")
    print(f"[serve] decode {args.gen} steps: {t_dec*1e3:.1f} ms "
          f"({t_dec/args.gen*1e3:.1f} ms/tok incl. first-call compile)")
    print(f"[serve] sample tokens: {toks[0][:10].tolist()}")
    return toks


if __name__ == "__main__":
    main()

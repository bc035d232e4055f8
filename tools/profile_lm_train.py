"""Where an eager LM training step spends the card's time.

Runs ``repro_torch``'s ``make_train_step`` for an arch of the registry at
full width on one CUDA card (seeded weights, the token pipeline at
(batch, seq)), one warm-up step, then profiles one step with
``torch.profiler``: the kernels' device time, the GEMMs' share, launches,
the flash forward's and backward's device time (``Flash`` /
``FlashBackward``, their kernels included), the largest kernels and the
largest operators. Imports neither JAX nor the reference.

    python tools/profile_lm_train.py --arch qwen2-1.5b --batch 8 --seq 4096
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    lm = LM(cfg, dev)
    lm.reset_parameters(torch.Generator(dev).manual_seed(0))
    params = {n: p.detach() for n, p in lm.named_parameters()}
    del lm
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    step = steps.make_train_step(cfg)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
    ctx_len = cfg.num_img_tokens or cfg.num_audio_frames

    def batch(i):
        b = pipe.batch(i, dev)
        if ctx_len:
            g = torch.Generator(dev).manual_seed(i)
            b["context"] = torch.randn((args.batch, ctx_len, cfg.d_model), generator=g, device=dev)
        return b

    params, state, _ = step(params, state, batch(0))
    torch.cuda.synchronize()
    b1 = batch(1)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, state, b1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels if any(t in e.key for t in ("nvjet", "gemm", "cutlass"))) / 1e3
    ops = [e for e in ka if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    out = {
        "card": card, "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch, "seq": args.seq,
        "profiled_wall_ms": 1e3 * wall, "kernel_ms": total, "gemm_ms": gemm,
        "launches": sum(e.count for e in kernels),
        "flash_ms": {e.key: e.device_time_total / 1e3 for e in ka if e.key in ("Flash", "FlashBackward")},
        "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]],
        "top_operators_ms": [[e.key, e.self_device_time_total / 1e3, e.count]
                             for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]],
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

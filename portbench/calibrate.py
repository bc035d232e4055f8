"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... [--control 1,2,3] [--forwards 3]

The program is set up once; for each seed its weights and features are
made again in place, the session runs ``--forwards`` calls, and its last
logits are compared with the float32 reference (every number of
``refcore.compare``, for each near-tie margin of ``MARGINS``). For each
``--control`` seed the same numbers are read of the control, the reference
in TF32 put in the program's place, and of three faults planted in the
reference's answer: no forward (zeros), half of the targets left out
(their rows zero) and one answer altered (its row negated). One JSON line
a reading on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MARGINS = (1e-7, 1e-6, 1e-5, 1e-4)


def faults(ref):
    """The answers of a broken timed path, made from the reference's."""
    import torch

    half = ref.clone()
    half[ref.shape[0] // 2:] = 0
    one = ref.clone()
    one[0] = -one[0]
    return {"no_forward": torch.zeros_like(ref), "half_left_out": half, "one_altered": one}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import run as _run

    os.environ["CUDA_CACHE_PATH"] = str(_run.CUDA_CACHE)
    import torch

    from portbench import harness, inputs, refcore

    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prog = harness.build_program(cell, seeds[0], dev, lambda m: print(m, file=sys.stderr, flush=True))
    lt = prog.graph["label_type"]
    print(json.dumps({"setup_s": time.perf_counter() - T_START, "prepare_s": prog.prepare_s,
                      "capture_s": prog.capture_s}), flush=True)

    def emit(seed, kind, got, logits, rec, ref_s):
        tied = rec.tied_rows(lt)
        line = {"seed": seed, "kind": kind, "ref_s": ref_s,
                "near_ties": [e["near_ties"] for e in rec.entries]}
        for i, m in enumerate(MARGINS):
            line[f"eps={m:g}"] = refcore.compare(got, logits, tied[i])
        print(json.dumps(line), flush=True)

    for seed in seeds:
        params, _ = inputs.make_inputs(prog.shapes, prog.graph, cell.traffic["graph"]["feat_noise"], seed, dev,
                                       features=prog.task.batch.features)
        for _ in range(args.forwards):
            got = prog.session(params)
        sync()
        t0 = time.perf_counter()
        logits, rec = harness.reference(cell, prog.graph, prog.shapes, seed, dev, "float32", list(MARGINS))
        sync()
        emit(seed, "program", got, logits, rec, time.perf_counter() - t0)
        if seed in control:
            t0 = time.perf_counter()
            ctrl, _ = harness.reference(cell, prog.graph, prog.shapes, seed, dev, "tf32", list(MARGINS))
            sync()
            emit(seed, "control_tf32", ctrl, logits, rec, time.perf_counter() - t0)
            for name, bad in faults(logits).items():
                emit(seed, f"fault_{name}", bad, logits, rec, 0.0)
        del got, logits, rec
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the result as the last line of standard output (one JSON
object) and the numbers compared, each beside its limit, as the last lines
of standard error. Exits 2 without the card(s) or without the program
(``src/repro_torch``), 3 when JAX or the JAX package was loaded.
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
CACHE = ROOT / "build" / "portbench"
# top-level module names the run may not load (compared whole: the
# program's package is repro_torch, which only begins with repro)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the driver's kernel JIT cache, should any kernel need one, at a fixed
# path in the checkout (the program builds its own kernels into build/kernels)
CUDA_CACHE = CACHE / "nv_compute"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(CUDA_CACHE)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"portbench: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)  # the package is imported by its name, from the root
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start=T_START, cell=cell)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

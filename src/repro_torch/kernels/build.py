"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel package keeps its sources in ``csrc/`` with a plain C
interface (no PyTorch headers, so one build takes seconds). At first use,
:func:`load` compiles them into one shared library for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <srcs>

(no ``--use_fast_math``: ``expf`` and division stay IEEE-accurate), under
``build/kernels/`` at the repository root, keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
The library is written to a temporary name and renamed into place, so two
processes building at once never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

from repro_torch import trace

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (library, build record); one load per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "are built at first use and need the CUDA toolkit"
    )


def load(name: str, sources: Sequence[Path]) -> Tuple[ctypes.CDLL, dict]:
    """The shared library built from ``sources``, and a record of its build
    (``path``, ``seconds`` — 0 when reused — and ``log``, the compiler's
    output including ``ptxas`` register and shared-memory counts). The
    first load in the process is the build span ``kernels.load``, its
    ``status`` ``built`` or ``reused``."""
    if name in _LOADED:
        return _LOADED[name]
    with trace.span("kernels.load", always=True, kernel=name) as sp:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            h.update(Path(src).read_bytes())
        out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
        record = {"path": str(out), "seconds": 0.0, "log": ""}
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {name}:\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            record["seconds"] = time.perf_counter() - t0
            record["log"] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        sp.set(status="built" if record["seconds"] else "reused")
    _LOADED[name] = (lib, record)
    return lib, record

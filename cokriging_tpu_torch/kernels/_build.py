"""Builds and loads the hand-written CUDA kernels.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) at first use and
loaded with ``ctypes``. All sources are compiled at once, one ``nvcc``
process each. Libraries go to ``build/cokriging_tpu_torch/<digest>/`` at
the repository root, keyed by a hash of every file in ``csrc/`` and of the
flags, so an edited source (or the shared header ``kv.cuh``) rebuilds every
library and an unchanged tree loads directly.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("variogram.cu", "matern.cu", "matern_grad.cu", "matern_pairs.cu", "matern_hess.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cokriging_tpu_torch"

_LIBS = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build() -> dict:
    """Compile every source that is not built yet for the current digest.

    Returns ``{"dir": str, "seconds": float, "ptxas": [lines]}``; ``seconds``
    is 0 when every library was already built, and the ptxas lines are the
    register, shared-memory and spill reports of the build that made them.
    """
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / "ptxas.log"
    todo = [s for s in SOURCES if not (out_dir / _lib_name(s)).exists()]
    seconds = 0.0
    if todo:
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = []
        for src in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((src, tmp, proc))
        logs, failed = [], []
        for src, tmp, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src} (rc {proc.returncode}):\n{text}")
                os.unlink(tmp)
            else:
                os.replace(tmp, out_dir / _lib_name(src))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        with open(log_path, "a") as f:
            f.write("\n".join(logs))
        seconds = time.perf_counter() - t0
    ptxas = []
    if log_path.exists():
        ptxas = [
            line.strip()
            for line in log_path.read_text().splitlines()
            if line.startswith("==") or "Compiling entry function" in line
            or "registers" in line or "spill" in line
        ]
    return {"dir": str(out_dir), "seconds": seconds, "ptxas": ptxas}


def _lib_name(src: str) -> str:
    return "lib" + Path(src).stem + ".so"


def load(src: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<src>``, building it first if
    needed."""
    if src not in _LIBS:
        out_dir = Path(build()["dir"])
        _LIBS[src] = ctypes.CDLL(str(out_dir / _lib_name(src)))
    return _LIBS[src]

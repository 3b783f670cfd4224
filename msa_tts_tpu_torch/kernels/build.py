"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``msa_tts_tpu_torch/csrc/`` with a
plain C interface.  It is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root, keyed by a hash of the source
and the flags, at first use, and loaded with ``ctypes``.  Nothing is
built at import time: the CPU tests import every module on hosts that
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling, ptxas report) for builds done here
build_log: dict[str, tuple[float, str]] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built on "
        "the machine with the GPU"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash has no library yet, then load
    it.  A failed build raises with the compiler's output."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{res.stdout}\n{res.stderr}"
                )
            os.replace(tmp, so)
            build_log[name] = (time.perf_counter() - t0,
                               res.stdout + res.stderr)
        lib = ctypes.CDLL(str(so))
        _loaded[name] = lib
        return lib

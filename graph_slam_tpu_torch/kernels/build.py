"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``. No PyTorch headers are included, which keeps a build to
seconds. The library lands in ``graph_slam_tpu_torch/_build/``, named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads what is there. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["library", "library_path", "ensure_built", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives (built or not)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def ensure_built(name: str) -> bool:
    """Build ``csrc/<name>.cu`` unless its library exists; True if built."""
    src = os.path.join(CSRC, name + ".cu")
    out = library_path(name)
    if os.path.exists(out):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    ensure_built(name)
    return ctypes.CDLL(library_path(name))

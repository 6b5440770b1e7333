"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` exposes a plain C entry point. At first use
it is compiled by nvcc into a shared library under `build/torch_kernels/`
at the repository root and loaded with ctypes. The file name carries a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. A failed build raises with nvcc's stderr. Nothing is
downloaded and no library kernel is linked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # exact float32: no fused multiply-adds, no fast-math intrinsics, so the
    # kernel's distances and tie-breaks match the plain PyTorch version
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA kernels need it")
    return str(path)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source and these
    flags exists; returns the library's path."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {name}:\n{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` exposes plain C entry points. At first use
it is compiled by nvcc into a shared library under `build/torch_kernels/`
at the repository root and loaded with ctypes; `build_all` compiles several
sources at once. The file name carries a hash of the source, of every
`csrc/` header it includes (`#include "name.cuh"`, e.g. warp_select.cuh)
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. A failed build raises with nvcc's stderr. Nothing is
downloaded and no library kernel is linked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # exact float32: no fused multiply-adds but the explicit fmaf calls, no
    # fast-math intrinsics, so the kernels' distances and tie-breaks match
    # the plain PyTorch versions
    "--fmad=false",
    # ptxas reports each kernel's registers, shared memory and spills
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

SMEM_MAX = 232_448  # bytes of shared memory one block may use on the H100 (sm_90)

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc's stderr (the ptxas report) of each source built in this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA kernels need it")
    return str(path)


def _sources(name: str) -> list[Path]:
    """csrc/<name>.cu and the csrc/ headers it includes, directly or through
    another header, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            if CSRC / inc not in found:
                found.append(CSRC / inc)
    return found


def _library(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each csrc/<name>.cu whose library for this source and these
    flags is missing, one nvcc process per source, all started together;
    returns each library's path. Raises, after every nvcc has ended, if one
    failed."""
    paths = {name: _library(name) for name in names}
    jobs = []
    for name, out in paths.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, proc, tmp, out, cmd))
    failed = []
    for name, proc, tmp, out, cmd in jobs:
        _, err = proc.communicate()
        BUILD_LOG[name] = err
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n{' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; returns its path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

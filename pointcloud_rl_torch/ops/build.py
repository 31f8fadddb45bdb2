"""Build the package's native sources at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by hand
with nvcc (no PyTorch headers, so a build takes seconds) into
``build/pointcloud_rl_torch/lib<name>_<hash>.so`` under the repository root;
each ``csrc/<name>.cpp`` (host code) likewise with g++.  The hash of the
source and the flags is part of the file name, so an edited source is
rebuilt and a stale library is never loaded.  The build writes to a
temporary file and renames it, so concurrent processes never load a
half-written library.  This module imports neither torch nor numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pointcloud_rl_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
HOST_FLAGS = ["-O3", "-shared", "-fPIC"]  # portable: no -march=native

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built at first use")
    return nvcc


def library_path(name: str, suffix: str = ".cu") -> Path:
    src = CSRC_DIR / f"{name}{suffix}"
    flags = ARCH_FLAGS if suffix == ".cu" else HOST_FLAGS
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(cmd, src: Path, out: Path, verbose: bool) -> Path:
    """Run ``cmd + ["-o", tmp, src]`` and rename tmp to ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {src.name}:\n{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_library(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of each kernel)."""
    out = library_path(name)
    if out.exists():
        return out
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return _compile(cmd, CSRC_DIR / f"{name}.cu", out, verbose)


def build_host_library(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with g++ unless an
    up-to-date library exists."""
    out = library_path(name, ".cpp")
    if out.exists():
        return out
    return _compile(["g++", *HOST_FLAGS], CSRC_DIR / f"{name}.cpp", out, verbose=False)


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name, verbose=verbose)))
            _loaded[name] = lib
        return lib

"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source in tfssd_torch/csrc/ exports a plain C launch function,
so a build is one nvcc call (seconds) into a shared library, with no
PyTorch headers and no ninja. Libraries go to build/tfssd_torch/ at the
repository root (listed in .gitignore), named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
nvcc writes to a temporary name that is renamed into place only after it
succeeds: a killed build leaves no lock and no half-written library.

Nothing here runs at import: the CPU tests import every module, and a
build needs nvcc, which a CPU-only install does not have.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tfssd_torch"

# -fmad=false: no multiply-add contraction, so float results round as the
# plain PyTorch versions' separate elementwise operations do. Never fast
# math: division stays IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

BUILD_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildReport:
    """One build_library call: the library, its seconds, whether nvcc ran
    (False when the library of this source already existed) and nvcc's
    output (registers and shared memory from -Xptxas -v)."""

    path: Path
    seconds: float
    built: bool
    log: str


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PyTorch's CUDA_HOME, PATH, then
    /usr/local/cuda/bin; raises if none has it."""
    candidates = []
    env_home = os.environ.get("CUDA_HOME")
    if env_home:
        candidates.append(Path(env_home) / "bin" / "nvcc")
    try:
        from torch.utils.cpp_extension import CUDA_HOME as torch_home
    except ImportError:  # the module needs setuptools, which may be absent
        torch_home = None
    if torch_home:
        candidates.append(Path(torch_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, torch's CUDA_HOME, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def library_path(name: str) -> Path:
    """Where the library for the current source of `name` lives."""
    h = hashlib.sha256(_source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> BuildReport:
    """Compile csrc/<name>.cu unless a library of this source exists."""
    out = library_path(name)
    t0 = time.perf_counter()
    if out.is_file():
        return BuildReport(out, time.perf_counter() - t0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(_source(name))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return BuildReport(out, time.perf_counter() - t0, True,
                       proc.stdout + proc.stderr)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per
    process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name).path))
        _LIBS[name] = lib
    return lib

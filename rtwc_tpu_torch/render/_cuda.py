"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each source is compiled on first use into `rtwc_tpu_torch/_build/` as a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

It is rebuilt when the source, or any header in csrc/ (the .cu files
include them), is newer than the library, and written
atomically (temp file + rename, as rtwc_tpu/io/native/__init__.py:33-53
does), so concurrent processes never load a half-written file. nvcc's
output (the -Xptxas -v register / spill report) is kept beside the library
as lib<name>.log. Nothing here runs at import time: importing the kernel
modules needs no nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc per library by this process (0.0 when it was fresh).
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the toolkit's
    default prefix; raises RuntimeError when there is none."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join("/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH "
        "to build rtwc_tpu_torch's CUDA kernels")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def stale(name: str) -> bool:
    """True when lib<name>.so is missing or older than csrc/<name>.cu or
    any csrc/*.cuh header."""
    so = library_path(name)
    if not os.path.exists(so):
        return True
    inputs = [os.path.join(SRC_DIR, f"{name}.cu")] + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(f) for f in inputs)


def build(name: str) -> str:
    """Compile csrc/<name>.cu if the library is missing or stale; returns
    the library path. Raises RuntimeError with nvcc's output on failure."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    so = library_path(name)
    if not stale(name):
        build_seconds.setdefault(name, 0.0)
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        with open(so[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen lib<name>.so, once per process."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _libs[name] = lib
    return lib

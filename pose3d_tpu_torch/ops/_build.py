"""Build the package's CUDA sources (`csrc/*.cu`) at first use and load them.

Each source is compiled by nvcc for sm_90a into a shared library with a plain
C entry point, loaded with ctypes. No PyTorch headers are included, so a
build takes seconds. Libraries go to `pose3d_tpu_torch/build/` under a name
keyed by a hash of the source and the flags, so a changed source rebuilds;
nvcc's report (`-Xptxas=-v`: registers, shared memory, spills) is kept
beside each library as a `.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME "
                           "or /usr/local/cuda): the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` is built: keyed by the source and the flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library is already built; return
    the library's path. Concurrent processes each compile to a temporary file
    and rename it into place, so a reader never sees half a library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{proc.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib

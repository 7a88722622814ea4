"""Build the package's native sources at first use and load them.

Each CUDA source (`csrc/*.cu`) is compiled by nvcc for sm_90a into a shared
library with a plain C entry point, loaded with ctypes. No PyTorch headers
are included, so a build takes seconds. Each host source (`csrc/*.cpp`: the
PLY reader) is compiled the same way by the host's C++ compiler (`$CXX`,
else `c++` or `g++`) with `native/Makefile`'s flags. Libraries go to
`pose3d_tpu_torch/build/` under a name keyed by a hash of the source and the
flags, so a changed source rebuilds; the compiler's report (nvcc's
`-Xptxas=-v`: registers, shared memory, spills) is kept beside each library
as a `.log`.
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
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

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


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not path or not shutil.which(path):
        raise RuntimeError("no C++ compiler found (neither $CXX nor c++ or g++ on PATH): "
                           "one is needed to build the port's native PLY reader "
                           "(csrc/ply_reader.cpp)")
    return path


def _path(source: str, flags: tuple[str, ...]) -> str:
    name, _ = os.path.splitext(source)
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` is built: keyed by the source and the flags."""
    return _path(f"{name}.cu", NVCC_FLAGS)


def host_library_path(name: str) -> str:
    """Where `csrc/<name>.cpp` is built: keyed by the source and the flags."""
    return _path(f"{name}.cpp", HOST_CXX_FLAGS)


def _compile(source: str, compiler, flags: tuple[str, ...]) -> str:
    """Compile `csrc/<source>` unless its library is already built; return
    the library's path. Concurrent processes each compile to a temporary file
    and rename it into place, so a reader never sees half a library."""
    out = _path(source, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        exe = compiler()
        proc = subprocess.run([exe, *flags, "-o", tmp, os.path.join(CSRC_DIR, source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(exe)} failed to build csrc/{source}:\n"
                               f"{proc.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` with nvcc unless it is built; its path."""
    return _compile(f"{name}.cu", _nvcc, NVCC_FLAGS)


def build_host(name: str) -> str:
    """Compile `csrc/<name>.cpp` with the host's C++ compiler unless it is
    built; its path."""
    return _compile(f"{name}.cpp", _cxx, HOST_CXX_FLAGS)


def _load(key: str, build_fn, name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(build_fn(name))
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if need be."""
    return _load(f"{name}.cu", build, name)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cpp`, built first if need be."""
    return _load(f"{name}.cpp", build_host, name)

"""PLY vertex loading. Port of `pose3d_tpu/data/ply.py`: the native C++
reader (`csrc/ply_reader.cpp`, the port's own copy of
`native/ply_reader.cpp`, built at first use by the host's C++ compiler
through `ops/_build.py build_host` and bound with ctypes as JAX's
`_find_native` / `_load_native` bind theirs), the pure-numpy reader as its
plain version, and the per-process cache.

Both read ascii 1.0 and binary_little_endian 1.0 files with x, y, z among
the scalar vertex properties (any PLY scalar type), the vertex element first
(the `compressed.ply` clouds of the datasets are such files). The native
reader declines binary_big_endian (and any file it cannot read): those go
to the numpy reader, as JAX's `load_vertices` does, which raises where it
cannot read them either. Without a C++ compiler the first read raises,
naming it: nothing falls back to numpy unasked.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from pose3d_tpu_torch.ops import _build

_cache: dict[str, np.ndarray] = {}
_cache_lock = threading.Lock()
_native: ctypes.CDLL | None = None

_PROP_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _parse_header(f) -> tuple[str, int, list[tuple[str, str]]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, n_vertices, props, element, vertex_first = None, 0, [], None, False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            if tokens[1] == "vertex":
                n_vertices, vertex_first = int(tokens[2]), element is None
            element = tokens[1]
        elif tokens[0] == "property" and element == "vertex":
            if tokens[1] == "list":
                raise ValueError("list property in vertex element unsupported")
            props.append((tokens[1], tokens[2]))
        elif tokens[0] == "end_header":
            if not vertex_first:
                raise ValueError("PLY vertex element must come first")
            return fmt, n_vertices, props


def _library() -> ctypes.CDLL:
    global _native
    if _native is None:
        lib = _build.load_host("ply_reader")
        lib.ply_read_vertices.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
        lib.ply_read_vertices.restype = ctypes.POINTER(ctypes.c_float)
        lib.ply_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _native = lib
    return _native


def read_native(path: str) -> np.ndarray | None:
    """The (V, 3) float32 vertices by the native reader, or None where it
    declines the file (binary_big_endian among them)."""
    lib = _library()
    n = ctypes.c_long(0)
    ptr = lib.ply_read_vertices(os.fsencode(path), ctypes.byref(n))
    if not ptr:
        return None
    try:
        return np.ctypeslib.as_array(ptr, shape=(n.value, 3)).copy()
    finally:
        lib.ply_free(ptr)


def read_numpy(path: str) -> np.ndarray:
    """The (V, 3) float32 vertices by the numpy reader (the plain
    version)."""
    with open(path, "rb") as f:
        fmt, n, props = _parse_header(f)
        names = [name for _, name in props]
        if not all(k in names for k in "xyz"):
            raise ValueError(f"PLY vertex element lacks x/y/z: {names}")
        if fmt == "ascii":
            cols = [names.index(k) for k in "xyz"]
            out = np.empty((n, 3), np.float32)
            for i in range(n):
                vals = f.readline().split()
                out[i] = [float(vals[c]) for c in cols]
            return out
        if fmt in ("binary_little_endian", "binary_big_endian"):
            endian = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(name or f"p{j}", endian + _PROP_TYPES[ptype])
                           for j, (ptype, name) in enumerate(props)])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            return np.stack([raw[k].astype(np.float32) for k in "xyz"], axis=1)
        raise ValueError(f"unsupported PLY format {fmt}")


def load_vertices(path: str, cache: bool = True) -> np.ndarray:
    """The (V, 3) float32 vertex array of a PLY file, by the native reader
    or, where it declines the file, the numpy reader; parsed once per
    process by default."""
    if cache:
        with _cache_lock:
            hit = _cache.get(path)
        if hit is not None:
            return hit
    arr = read_native(path)
    if arr is None:
        arr = read_numpy(path)
    if cache:
        with _cache_lock:
            _cache[path] = arr
    return arr


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()

"""PLY vertex loading. Port of `pose3d_tpu/data/ply.py`, the pure-numpy
reader with its per-process cache (the JAX package's native C++ reader is
not used).

Reads ascii 1.0 and binary_little_endian / binary_big_endian 1.0 files with
float or double x, y, z among the vertex properties, the vertex element
first (the `compressed.ply` clouds of the datasets are such files).
"""

from __future__ import annotations

import threading

import numpy as np

_cache: dict[str, np.ndarray] = {}
_cache_lock = threading.Lock()

_PROP_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _parse_header(f) -> tuple[str, int, list[tuple[str, str]]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, n_vertices, props, element = None, 0, [], None
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
            element = tokens[1]
            if element == "vertex":
                n_vertices = int(tokens[2])
        elif tokens[0] == "property" and element == "vertex":
            if tokens[1] == "list":
                raise ValueError("list property in vertex element unsupported")
            props.append((tokens[1], tokens[2]))
        elif tokens[0] == "end_header":
            return fmt, n_vertices, props


def _read(path: str) -> np.ndarray:
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
    """The (V, 3) float32 vertex array of a PLY file, parsed once per
    process by default."""
    if cache:
        with _cache_lock:
            hit = _cache.get(path)
        if hit is not None:
            return hit
    arr = _read(path)
    if cache:
        with _cache_lock:
            _cache[path] = arr
    return arr


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()

"""Binary little-endian PLY reader and writer (counterpart of
contrastboundary_tpu/utils/ply.py: the same parsing, and files written byte
for byte as that module writes them).

Vertex elements only: ``read_ply`` skips the properties of any other
element (a mesh's faces are read by data/prepare_scannet.py::_read_faces).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    np.dtype("i1"): "char", np.dtype("u1"): "uchar",
    np.dtype("i2"): "short", np.dtype("u2"): "ushort",
    np.dtype("i4"): "int", np.dtype("u4"): "uint",
    np.dtype("i8"): "int",  # written as int32
    np.dtype("f4"): "float", np.dtype("f8"): "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a binary-little-endian PLY → {vertex property name: [N] array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a ply file")
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[-1], parts[1]))
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt}")
        dtype = np.dtype([(n, "<" + _PLY_TO_NP[t]) for n, t in props])
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
    return {n: np.asarray(data[n]) for n, _ in props}


def write_ply(path: str, arrays: Sequence[np.ndarray], names: Sequence[str]):
    """Write columns as one binary vertex element. An [N, k] array takes k
    names (e.g. one [N, 3] array and names ['x', 'y', 'z'])."""
    cols: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        cols.extend([a] if a.ndim == 1 else [a[:, i] for i in range(a.shape[1])])
    if len(cols) != len(names):
        raise ValueError(f"{len(cols)} columns but {len(names)} names")
    cols = [c.astype("i4") if c.dtype == np.dtype("i8") else c for c in cols]
    rec = np.empty(len(cols[0]), dtype=np.dtype(
        [(name, "<" + c.dtype.str[1:]) for name, c in zip(names, cols)]))
    for name, c in zip(names, cols):
        rec[name] = c
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(rec)}\n".encode())
        for name, c in zip(names, cols):
            f.write(f"property {_NP_TO_PLY[np.dtype(c.dtype.str[1:])]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())

"""One-time ScanNet raw → npy conversion (counterpart of
contrastboundary_tpu/data/prepare_scannet.py: the same files, byte for
byte, from the same seed).

Reads each scene's ``<scene>_vh_clean_2.ply`` (vertices x, y, z, red,
green, blue and triangle faces) and ``<scene>_vh_clean_2.labels.ply`` (a
raw label id a vertex), rasterizes the mesh at ``density`` points/m²
(utils/mesh.py: vertex colours interpolated, each face labelled by the
majority of its vertices, the vertices appended with their own labels) and
writes ``<out>/<scene>.npy``, float32 [N, 7] xyzrgb + raw label id, which
data/datasets.py::ScanNetDataset maps to the 20 classes when it loads it.

    python -m contrastboundary_tpu_torch.data.prepare_scannet <raw root> <out dir>
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from ..utils.mesh import rasterize_mesh
from ..utils.ply import read_ply

_PROPERTY_BYTES = {"float": 4, "double": 8, "uchar": 1, "char": 1, "int": 4, "uint": 4,
                   "short": 2, "ushort": 2, "uint8": 1, "int32": 4, "float32": 4, "uint16": 2}


def _read_faces(path: str) -> np.ndarray:
    """The vertex-index triples of a binary ply's face element (a uchar
    count, then int32 indices: ScanNet's layout) → [F, 3] int64."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a ply")
        n_vert = n_face = 0
        vert_size = 0
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            p = line.split()
            if p[0] == "element":
                in_vertex = p[1] == "vertex"
                if p[1] == "vertex":
                    n_vert = int(p[2])
                elif p[1] == "face":
                    n_face = int(p[2])
            elif p[0] == "property" and in_vertex:
                vert_size += _PROPERTY_BYTES[p[1]]
        f.seek(n_vert * vert_size, os.SEEK_CUR)
        raw = f.read(n_face * 13)
    if len(raw) != n_face * 13:
        raise ValueError(f"{path}: {n_face} faces declared, {len(raw)} bytes of faces")
    rec = np.frombuffer(raw, np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    bad = rec["n"] != 3
    if bad.any():
        raise ValueError(f"{path}: non-triangle face ({rec['n'][bad][0]})")
    return rec["v"].astype(np.int64)


def convert_scene(mesh_ply: str, labels_ply: str, density: float = 2000.0,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """One scene → [N, 7] xyzrgb + raw label (``rng`` default: seed 0)."""
    v = read_ply(mesh_ply)
    vertices = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float64)
    lab = read_ply(labels_ply)["label"].astype(np.int64)
    faces = _read_faces(mesh_ply)

    # face label = majority of its three vertex labels (no majority: the first)
    fl = lab[faces]
    face_labels = np.where((fl[:, 1] == fl[:, 2]) & (fl[:, 0] != fl[:, 1]), fl[:, 1], fl[:, 0])
    pts, attrs, labels = rasterize_mesh(
        vertices, faces, density=density, vertex_attrs=colors, face_labels=face_labels,
        rng=rng or np.random.default_rng(0), include_vertices=True)
    labels[-len(vertices):] = lab  # the appended vertices carry their own labels
    return np.concatenate([pts, attrs, labels[:, None].astype(np.float32)],
                          axis=1).astype(np.float32)


def prepare_scannet(raw_root: str, out_dir: str, density: float = 2000.0,
                    verbose: bool = True) -> List[str]:
    """Convert every ``<raw_root>/<scene>/<scene>_vh_clean_2.ply`` scene
    that has its labels file; scenes already converted are skipped → the
    files written."""
    os.makedirs(out_dir, exist_ok=True)
    converted = []
    for mesh in sorted(glob.glob(os.path.join(raw_root, "*", "*_vh_clean_2.ply"))):
        scene = os.path.basename(mesh)[: -len("_vh_clean_2.ply")]
        labels = mesh[: -len(".ply")] + ".labels.ply"
        out = os.path.join(out_dir, f"{scene}.npy")
        if os.path.exists(out) or not os.path.exists(labels):
            continue
        arr = convert_scene(mesh, labels, density)
        np.save(out, arr)
        converted.append(out)
        if verbose:
            print(f"{out}: {arr.shape}")
    return converted


if __name__ == "__main__":
    import sys

    prepare_scannet(sys.argv[1], sys.argv[2])

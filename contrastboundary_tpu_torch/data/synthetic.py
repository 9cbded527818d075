"""Training crops of procedural rooms without augmentation: ``train_batch``,
the batches of every train phase before the data pipeline was ported, kept
as they were (data/pipeline.py does the voxelization and the crop).
``SyntheticSceneDataset`` and ``voxelize`` are re-exported from
data/s3dis.py and data/pipeline.py.

``write_scannet_scene`` writes a procedural room as a raw ScanNet scene
(the two binary ply meshes that data/prepare_scannet.py reads), so that the
ScanNet path runs without the (licence-gated) dataset.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from .datasets import SCANNET_RAW_IDS
from .pipeline import crop_around, voxelize
from .s3dis import SyntheticSceneDataset

__all__ = ["SyntheticSceneDataset", "train_batch", "voxelize", "write_scannet_scene"]


def train_batch(dataset: SyntheticSceneDataset, batch_size: int, n_points: int,
                rng: np.random.Generator, voxel_size: float = 0.04,
                voxel_max: int = 80_000) -> Dict[str, np.ndarray]:
    """``batch_size`` training crops of random rooms: voxelize (a random
    point per voxel), keep the ``voxel_max`` points nearest a random centre,
    then exactly ``n_points`` rows (a random permutation's first n_points,
    or all rows permuted and padded by repeating random rows), zero-min
    coordinates, colours/255 → points [B, N, 3] f32, features [B, N, 3] f32,
    labels [B, N] int32."""
    out = {"points": [], "features": [], "labels": []}
    for _ in range(batch_size):
        coord, feat, label = dataset.room(int(rng.integers(dataset.num_rooms)))
        coord = coord - coord.min(0)
        pick = voxelize(coord, voxel_size, rng)
        coord, feat, label = coord[pick], feat[pick], label[pick]
        if len(coord) > voxel_max:
            crop = crop_around(coord, int(rng.integers(len(coord))), voxel_max)
            coord, feat, label = coord[crop], feat[crop], label[crop]
        n = len(coord)
        if n >= n_points:
            idx = rng.permutation(n)[:n_points]
        else:
            idx = np.concatenate([rng.permutation(n), rng.integers(0, n, n_points - n)])
        coord = coord[idx]
        out["points"].append((coord - coord.min(0)).astype(np.float32))
        out["features"].append(feat[idx].astype(np.float32) / 255.0)
        out["labels"].append(label[idx].astype(np.int32))
    return {k: np.stack(v) for k, v in out.items()}


def _rect(origin, u, v, cell: float):
    """A rectangle origin + [0, 1]·u + [0, 1]·v as a grid of triangles about
    ``cell`` apart → (vertices [V, 3], faces [F, 3])."""
    origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
    nu = max(int(np.ceil(np.linalg.norm(u) / cell)), 1)
    nv = max(int(np.ceil(np.linalg.norm(v) / cell)), 1)
    a, b = np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1)
    verts = (origin + a[:, None, None] * u + b[None, :, None] * v).reshape(-1, 3)
    idx = np.arange(len(verts)).reshape(nu + 1, nv + 1)
    q0, q1, q2, q3 = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    faces = np.concatenate([np.stack([q0, q1, q2], -1).reshape(-1, 3),
                            np.stack([q0, q2, q3], -1).reshape(-1, 3)])
    return verts, faces


def _write_mesh_ply(path: str, vertex: np.ndarray, faces: np.ndarray) -> None:
    """A binary ply of a vertex element (the structured array's fields) and
    a triangle face element (uchar count, int indices), as ScanNet's."""
    types = {"f4": "float", "u1": "uchar", "u2": "ushort"}
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertex)}"]
    head += [f"property {types[vertex.dtype[n].str[1:]]} {n}" for n in vertex.dtype.names]
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    rec = np.empty(len(faces), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    rec["n"], rec["v"] = 3, faces
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(vertex.tobytes())
        f.write(rec.tobytes())


def write_scannet_scene(root: str, name: str, rng: np.random.Generator,
                        size: Sequence[float] = (6.0, 6.0, 3.0), n_boxes: int = 6,
                        cell: float = 0.25, ignored_fraction: float = 0.02) -> str:
    """A procedural room as ScanNet's raw scene ``<root>/<name>/``:
    ``<name>_vh_clean_2.ply`` (x, y, z, red, green, blue, alpha and faces)
    and ``<name>_vh_clean_2.labels.ply`` (the same with a raw label id a
    vertex). A floor (raw id 2) and four walls (1) of ``size`` metres and
    ``n_boxes`` boxes (tops and sides) labelled with furniture ids of
    SCANNET_RAW_IDS, the last one with an id the benchmark ignores (40);
    ``ignored_fraction`` of the vertices relabelled 0 (unannotated).
    Colours: a colour a label, with noise. → the scene directory."""
    sx, sy, sz = size
    parts = [((0, 0, 0), (sx, 0, 0), (0, sy, 0), 2),
             ((0, 0, 0), (sx, 0, 0), (0, 0, sz), 1), ((0, sy, 0), (sx, 0, 0), (0, 0, sz), 1),
             ((0, 0, 0), (0, sy, 0), (0, 0, sz), 1), ((sx, 0, 0), (0, sy, 0), (0, 0, sz), 1)]
    furniture = [i for i in SCANNET_RAW_IDS if i > 2]
    for i in range(n_boxes):
        w, d = sx * rng.uniform(0.08, 0.2), sy * rng.uniform(0.08, 0.2)
        h = sz * rng.uniform(0.13, 0.33)
        x, y = rng.uniform(0.03 * sx, 0.97 * sx - w), rng.uniform(0.03 * sy, 0.97 * sy - d)
        label = 40 if i == n_boxes - 1 else int(rng.choice(furniture))
        parts += [((x, y, h), (w, 0, 0), (0, d, 0), label),
                  ((x, y, 0), (w, 0, 0), (0, 0, h), label),
                  ((x, y + d, 0), (w, 0, 0), (0, 0, h), label),
                  ((x, y, 0), (0, d, 0), (0, 0, h), label),
                  ((x + w, y, 0), (0, d, 0), (0, 0, h), label)]
    verts, faces, labels = [], [], []
    n = 0
    for origin, u, v, label in parts:
        vv, ff = _rect(origin, u, v, cell)
        verts.append(vv)
        faces.append(ff + n)
        labels.append(np.full(len(vv), label))
        n += len(vv)
    verts, faces, labels = np.concatenate(verts), np.concatenate(faces), np.concatenate(labels)
    palette = rng.integers(0, 256, (41, 3))
    colors = np.clip(palette[labels] + rng.normal(0, 12, (n, 3)), 0, 255).astype(np.uint8)
    labels[rng.random(n) < ignored_fraction] = 0

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
              ("blue", "u1"), ("alpha", "u1")]
    mesh = np.empty(n, np.dtype(fields))
    lab = np.empty(n, np.dtype(fields + [("label", "<u2")]))
    for rec in (mesh, lab):
        rec["x"], rec["y"], rec["z"] = verts.T
        rec["red"], rec["green"], rec["blue"] = colors.T
        rec["alpha"] = 255
    lab["label"] = labels
    scene = os.path.join(root, name)
    os.makedirs(scene, exist_ok=True)
    _write_mesh_ply(os.path.join(scene, f"{name}_vh_clean_2.ply"), mesh, faces)
    _write_mesh_ply(os.path.join(scene, f"{name}_vh_clean_2.labels.ply"), lab, faces)
    return scene

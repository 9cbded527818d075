"""Triangle-mesh rasterization to point clouds (counterpart of
contrastboundary_tpu/utils/mesh.py: the same draws from the generator passed
in, in the same order, so a seed gives the same points bit for bit).

Points are sampled on each face with a Poisson count ∝ its area (plus the
vertices themselves), carrying barycentrically interpolated vertex
attributes and the face's label. ScanNet's meshes are prepared with it
(data/prepare_scannet.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 1]] - vertices[faces[:, 0]]
    b = vertices[faces[:, 2]] - vertices[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=1)


def rasterize_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    density: float = 1000.0,
    vertex_attrs: Optional[np.ndarray] = None,
    face_labels: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    include_vertices: bool = True,
):
    """Sample ~``density`` points per unit area on a triangle mesh.

    vertices [V, 3] float; faces [F, 3] int; vertex_attrs [V, C] interpolated
    barycentrically; face_labels [F] copied to each of a face's samples.
    Returns (points [N, 3] f32, attrs [N, C] f32 | None, labels [N] i64 |
    None).
    """
    rng = rng or np.random.default_rng()
    counts = rng.poisson(np.maximum(face_areas(vertices, faces) * density, 0.0))
    total = int(counts.sum())

    face_idx = np.repeat(np.arange(len(faces)), counts)
    # uniform barycentric sampling: u, v ~ U(0, 1), folded into the triangle
    u = rng.random(total)
    v = rng.random(total)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    bary = np.stack([1 - u - v, u, v], axis=1)  # [N, 3]
    pts = np.einsum("nk,nkd->nd", bary, vertices[faces[face_idx]])

    attrs = None
    if vertex_attrs is not None:
        attrs = np.einsum("nk,nkc->nc", bary, vertex_attrs[faces[face_idx]])
    labels = face_labels[face_idx] if face_labels is not None else None

    if include_vertices:
        pts = np.concatenate([pts, vertices])
        if attrs is not None:
            attrs = np.concatenate([attrs, vertex_attrs])
        if labels is not None:
            # a vertex takes the label of the last face (in face order) that
            # holds it
            vlab = np.full(len(vertices), -1, labels.dtype)
            for c in range(3):
                vlab[faces[:, c]] = face_labels
            labels = np.concatenate([labels, vlab])
    return (pts.astype(np.float32), None if attrs is None else attrs.astype(np.float32),
            None if labels is None else labels.astype(np.int64))

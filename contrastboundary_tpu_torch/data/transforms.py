"""Point/colour augmentations, functional and explicitly seeded (counterpart
of contrastboundary_tpu/data/transforms.py, the same draws in the same
order, so a seed gives the same arrays bit for bit).

The augmentation distribution of the reference's PyTorch stack (RandomRotate
z, RandomScale 0.9-1.1, RandomFlip xy, RandomJitter, Chromatic* and
hue/saturation in HSV), as pure functions of a ``np.random.Generator``: no
global RNG state, so every sample is reproducible from (seed, epoch, index).

All functions take and return (coord [N,3], feat [N,C] with rgb in 0..255,
label [N]) and never mutate inputs.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Transform = Callable[[np.random.Generator, np.ndarray, np.ndarray, np.ndarray], tuple]


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, rng, coord, feat, label):
        for t in self.transforms:
            coord, feat, label = t(rng, coord, feat, label)
        return coord, feat, label


def _rot_matrix(ax, ay, az):
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def random_rotate(angle=(0.0, 0.0, 1.0)):
    def t(rng, coord, feat, label):
        a = [rng.uniform(-a_, a_) * np.pi for a_ in angle]
        r = _rot_matrix(*a)
        return coord @ r.T, feat, label

    return t


def random_scale(scale=(0.9, 1.1), anisotropic=False):
    def t(rng, coord, feat, label):
        s = rng.uniform(scale[0], scale[1], 3 if anisotropic else 1)
        return coord * s, feat, label

    return t


def random_shift(shift=(0.2, 0.2, 0.0)):
    def t(rng, coord, feat, label):
        d = np.array([rng.uniform(-s, s) for s in shift])
        return coord + d, feat, label

    return t


def random_flip(p=0.5):
    def t(rng, coord, feat, label):
        coord = coord.copy()
        if rng.random() < p:
            coord[:, 0] = -coord[:, 0]
        if rng.random() < p:
            coord[:, 1] = -coord[:, 1]
        return coord, feat, label

    return t


def random_jitter(sigma=0.01, clip=0.05):
    def t(rng, coord, feat, label):
        j = np.clip(sigma * rng.standard_normal((coord.shape[0], 3)), -clip, clip)
        return coord + j, feat, label

    return t


def chromatic_auto_contrast(p=0.2, blend_factor=None):
    def t(rng, coord, feat, label):
        if rng.random() < p:
            feat = feat.copy()
            lo = feat[:, :3].min(0, keepdims=True)
            hi = feat[:, :3].max(0, keepdims=True)
            scale = 255.0 / np.maximum(hi - lo, 1e-6)
            stretched = (feat[:, :3] - lo) * scale
            b = rng.random() if blend_factor is None else blend_factor
            feat[:, :3] = (1 - b) * feat[:, :3] + b * stretched
        return coord, feat, label

    return t


def chromatic_translation(p=0.95, ratio=0.05):
    def t(rng, coord, feat, label):
        if rng.random() < p:
            feat = feat.copy()
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * ratio
            feat[:, :3] = np.clip(feat[:, :3] + tr, 0, 255)
        return coord, feat, label

    return t


def chromatic_jitter(p=0.95, std=0.005):
    def t(rng, coord, feat, label):
        if rng.random() < p:
            feat = feat.copy()
            noise = rng.standard_normal((feat.shape[0], 3)) * std * 255
            feat[:, :3] = np.clip(feat[:, :3] + noise, 0, 255)
        return coord, feat, label

    return t


def _rgb_to_hsv(rgb):
    """Vectorized rgb(0..255) → hsv(h,s in 0..1, v in 0..255)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-9), 0.0)
    dz = np.maximum(delta, 1e-9)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t_ = v * (1 - s * (1 - f))
    conds = [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5]
    r = np.select(conds, [v, q, p, p, t_, v])
    g = np.select(conds, [t_, v, v, q, p, p])
    b = np.select(conds, [p, p, t_, v, v, q])
    rgb = np.stack([r, g, b], -1)
    return np.where(s[..., None] == 0, np.stack([v, v, v], -1), rgb)


def hue_saturation_translation(hue_max=0.5, saturation_max=0.2):
    def t(rng, coord, feat, label):
        feat = feat.copy()
        hsv = _rgb_to_hsv(feat[:, :3].astype(np.float64))
        hue = (rng.random() - 0.5) * 2 * hue_max
        sat = 1 + (rng.random() - 0.5) * 2 * saturation_max
        hsv[..., 0] = (hsv[..., 0] + hue + 1) % 1.0
        hsv[..., 1] = np.clip(hsv[..., 1] * sat, 0, 1)
        feat[:, :3] = np.clip(_hsv_to_rgb(hsv), 0, 255)
        return coord, feat, label

    return t


def random_drop_color(p=0.2):
    def t(rng, coord, feat, label):
        if rng.random() < p:
            feat = feat.copy()
            feat[:, :3] = 0
        return coord, feat, label

    return t


def default_train_transform() -> Compose:
    """The flagship's training augmentation (pytorch/tool/train.py:226-232)."""
    return Compose(
        [
            random_scale((0.9, 1.1)),
            chromatic_auto_contrast(),
            chromatic_translation(),
            chromatic_jitter(),
            hue_saturation_translation(),
        ]
    )

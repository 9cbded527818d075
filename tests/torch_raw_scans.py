"""Raw dataset trees fabricated from a seed for the preparer tests: S3DIS
annotation files, Semantic3D ascii scans (with and without ``.labels``)
and NPM3D ply scans (with and without a ``class`` field). Coordinates lie
on a 1/64 m grid, which the text files hold exactly."""
import os

import numpy as np

from contrastboundary_tpu_torch.utils.ply import write_ply


def _cloud(rng, n, extent=(4.0, 4.0, 2.0)):
    return (np.floor(rng.random((n, 3)) * np.asarray(extent) * 64) / 64).astype(np.float32)


def write_s3dis_tree(root, rng):
    """Two areas: rooms with known classes, an unknown class name (clutter),
    a one-row annotation file, and a stray file beside the rooms."""
    rooms = {("Area_1", "office_1"): ("chair_1", "wall_2", "stairs_1"),
             ("Area_1", "hallway_2"): ("floor_1", "lamp_3"),
             ("Area_5", "office_3"): ("table_1", "board_2", "ceiling_1")}
    for (area, room), parts in rooms.items():
        ann = os.path.join(root, area, room, "Annotations")
        os.makedirs(ann, exist_ok=True)
        for k, part in enumerate(parts):
            n = 1 if part == "lamp_3" else int(rng.integers(50, 200))
            xyz = _cloud(rng, n)
            rgb = rng.integers(0, 256, (n, 3))
            with open(os.path.join(ann, f"{part}.txt"), "w") as f:
                for p, c in zip(xyz, rgb):
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
    with open(os.path.join(root, "Area_1", "readme.txt"), "w") as f:
        f.write("not a room\n")
    return str(root)


def semantic3d_scan(rng, n):
    """(xyz, intensity, rgb, raw labels 0-8) of an outdoor-like scan."""
    xyz = _cloud(rng, n, (6.0, 6.0, 3.0))
    labels = np.clip((xyz[:, 2] * 3).astype(np.int64) + (xyz[:, 0] > 3) * 4, 0, 8)
    labels[rng.random(n) < 0.05] = 0  # unlabeled
    return xyz, rng.integers(-2048, 2048, n), rng.integers(0, 256, (n, 3)), labels


def write_semantic3d_tree(root, rng, train=("bildstein_1", "untermaederbrunnen_3"),
                          test=("marketsquarefeldkirch_4",), n=3000):
    """``<name>.txt`` (x y z intensity r g b) for every scan, and
    ``<name>.labels`` for the train scans."""
    os.makedirs(root, exist_ok=True)
    for name in (*train, *test):
        xyz, inten, rgb, labels = semantic3d_scan(rng, n)
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            for p, i, c in zip(xyz, inten, rgb):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {i} {c[0]} {c[1]} {c[2]}\n")
        if name in train:
            np.savetxt(os.path.join(root, f"{name}.labels"), labels, fmt="%d")
    return str(root)


def write_npm3d_tree(root, rng, train=("Lille1", "Paris"), test=("ajaccio_2",), n=3000):
    """``<name>.ply`` (x y z reflectance, and class 0-9 for the train
    scans)."""
    os.makedirs(root, exist_ok=True)
    for name in (*train, *test):
        xyz = _cloud(rng, n, (8.0, 8.0, 4.0)).astype(np.float64)
        refl = rng.random(n).astype(np.float32)
        arrays, names = [xyz, refl], ["x", "y", "z", "reflectance"]
        if name in train:
            cls = rng.integers(0, 10, n).astype(np.int32)
            arrays, names = arrays + [cls], names + ["class"]
        write_ply(os.path.join(root, f"{name}.ply"), arrays, names)
    return str(root)

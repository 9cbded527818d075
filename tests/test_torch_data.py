"""The port's data pipeline (contrastboundary_tpu_torch/data/) against the JAX
package's (contrastboundary_tpu/data/, numpy only: nothing is compiled) on
the same inputs and seeds: every transform, voxelize, prepare_crop in both
crop modes, the potential sampler, the fixed-size pad, S3DISDataset over
.npy rooms written here, and make_batch_iterator under both samplers and
two shards. Tolerance: none, every array bit for bit, and the caller's
generator left in the same state (its next draw equal). Also: prefetch
keeps the order and re-raises a producer's exception, and train_batch
gives the batches it gave before the pipeline was ported (a frozen copy
below)."""

import numpy as np
import pytest

from contrastboundary_tpu.data import pipeline as jp
from contrastboundary_tpu.data import prefetch as jpf
from contrastboundary_tpu.data import s3dis as js
from contrastboundary_tpu.data import transforms as jt
from contrastboundary_tpu_torch.data import pipeline as tp
from contrastboundary_tpu_torch.data import prefetch as tpf
from contrastboundary_tpu_torch.data import s3dis as ts
from contrastboundary_tpu_torch.data import synthetic as tsyn
from contrastboundary_tpu_torch.data import transforms as tt

ROOM = dict(num_rooms=3, points_per_room=8000, seed=2)


def room(i=0, **kw):
    return ts.SyntheticSceneDataset(**{**ROOM, **kw}).room(i)


def assert_same(a, b, what=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), what
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def same_draws(fn_jax, fn_port, seed):
    """Both functions on generators seeded alike: equal outputs, and the
    generators in the same state after."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    assert_same(fn_jax(rj), fn_port(rt))
    assert rj.random() == rt.random()


TRANSFORMS = [
    ("random_rotate", dict(angle=(0.1, 0.2, 1.0))),
    ("random_scale", dict()),
    ("random_scale", dict(anisotropic=True)),
    ("random_shift", dict()),
    ("random_flip", dict(p=0.7)),
    ("random_jitter", dict()),
    ("chromatic_auto_contrast", dict(p=1.0)),
    ("chromatic_auto_contrast", dict(p=1.0, blend_factor=0.3)),
    ("chromatic_translation", dict(p=1.0)),
    ("chromatic_jitter", dict(p=1.0)),
    ("hue_saturation_translation", dict()),
    ("random_drop_color", dict(p=1.0)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(TRANSFORMS)])
@pytest.mark.parametrize("seed", [0, 1])
def test_transform_matches_jax(name, kw, seed):
    coord, feat, label = room(0)
    tj, tport = getattr(jt, name)(**kw), getattr(tt, name)(**kw)
    same_draws(lambda r: tj(r, coord, feat, label), lambda r: tport(r, coord, feat, label), seed)


def test_default_train_transform_matches_jax():
    coord, feat, label = room(1)
    tj, tport = jt.default_train_transform(), tt.default_train_transform()
    assert isinstance(tport, tt.Compose) and len(tport.transforms) == 5
    for seed in range(3):
        same_draws(lambda r: tj(r, coord, feat, label), lambda r: tport(r, coord, feat, label),
                   seed)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_voxelize_matches_jax(mode):
    coord = room(0)[0]
    same_draws(lambda r: jp.voxelize(coord, 0.05, r, mode),
               lambda r: tp.voxelize(coord, 0.05, r, mode), 3)


@pytest.mark.parametrize("crop_mode,split,voxel_max,transform", [
    ("count", "train", 2048, False), ("count", "train", 2048, True),
    ("count", "val", 1500, False), ("radius", "train", 2048, True),
    ("radius", "train", 300, False),
])
def test_prepare_crop_matches_jax(crop_mode, split, voxel_max, transform):
    coord, feat, label = room(2)
    kw = dict(voxel_size=0.04, voxel_max=voxel_max, split=split, crop_mode=crop_mode,
              in_radius=1.0)
    same_draws(
        lambda r: jp.prepare_crop(coord, feat, label, r,
                                  transform=jt.default_train_transform() if transform else None,
                                  **kw),
        lambda r: tp.prepare_crop(coord, feat, label, r,
                                  transform=tt.default_train_transform() if transform else None,
                                  **kw),
        4)


@pytest.mark.parametrize("cap", [None, 500])
def test_potential_sampler_matches_jax(cap):
    dj = js.SyntheticSceneDataset(**ROOM)
    dt = ts.SyntheticSceneDataset(**ROOM)
    sj = jp.PotentialSampler(dj, 0.05, in_radius=1.0, cap=cap, seed=3)
    st = tp.PotentialSampler(dt, 0.05, in_radius=1.0, cap=cap, seed=3)
    for k in range(3):
        rj, rt = np.random.default_rng(k), np.random.default_rng(k)
        (cj, ij), (ct, it) = sj.next(rj), st.next(rt)
        assert cj == ct
        assert_same(ij, it, f"next {k}")
        assert_same(sj.crop(cj, ij), st.crop(ct, it), f"crop {k}")
        assert sj.min_potential() == st.min_potential()
        assert rj.random() == rt.random()
    for a, b in zip(sj.rooms, st.rooms):
        assert_same({k: v for k, v in a.items() if k != "tree"},
                    {k: v for k, v in b.items() if k != "tree"})


@pytest.mark.parametrize("n_points", [1000, 1500, 2048])
def test_pad_to_fixed_size_matches_jax(n_points):
    coord, feat, label = (a[:1500] for a in room(0))
    same_draws(lambda r: jp.pad_to_fixed_size(coord, feat, label, n_points, r),
               lambda r: tp.pad_to_fixed_size(coord, feat, label, n_points, r), 5)


@pytest.fixture(scope="module")
def npy_root(tmp_path_factory):
    """Three train rooms (areas 1 and 2) and one val room (area 5) as
    xyzrgbl .npy files."""
    root = tmp_path_factory.mktemp("s3dis")
    rooms = ts.SyntheticSceneDataset(num_rooms=4, points_per_room=6000, seed=5)
    for i, name in enumerate(["Area_1_office_1", "Area_2_hallway_1", "Area_1_wc_1",
                              "Area_5_office_2"]):
        c, f, l = rooms.room(i)
        np.save(root / f"{name}.npy", np.concatenate([c, f, l[:, None]], 1).astype(np.float32))
    (root / "notes.txt").write_text("not a room")
    return str(root)


def test_s3dis_dataset_matches_jax(npy_root):
    for split, loop in (("train", 3), ("val", 3)):
        dj = js.S3DISDataset(npy_root, split, loop=loop)
        dt = ts.S3DISDataset(npy_root, split, loop=loop)
        assert dt.names == dj.names and len(dt) == len(dj) and dt.num_rooms == dj.num_rooms
        for i in range(len(dt)):
            assert_same(dj.room(i), dt.room(i), f"{split} {i}")
    assert ts.S3DISDataset(npy_root, "val").names == ["Area_5_office_2"]
    assert len(ts.S3DISDataset(npy_root, "train", loop=3)) == 9
    with pytest.raises(FileNotFoundError):
        ts.S3DISDataset(npy_root, "val", test_area=3)
    assert ts.S3DIS_NAMES == js.S3DIS_NAMES


def test_synthetic_dataset_matches_jax():
    for split in ("train", "val"):
        dj = js.SyntheticSceneDataset(**ROOM, split=split, ignore_fraction=0.1)
        dt = ts.SyntheticSceneDataset(**ROOM, split=split, ignore_fraction=0.1)
        for i in range(ROOM["num_rooms"]):
            assert_same(dj.room(i), dt.room(i), f"{split} {i}")


@pytest.mark.parametrize("sampler,crop_mode", [("random", "count"), ("random", "radius"),
                                               ("potential", "count")])
@pytest.mark.parametrize("shard", [0, 1])
def test_make_batch_iterator_matches_jax(npy_root, sampler, crop_mode, shard):
    dj, dt = js.S3DISDataset(npy_root, loop=2), ts.S3DISDataset(npy_root, loop=2)
    kw = dict(seed=3, epoch=1, voxel_size=0.05, voxel_max=1500, shard_index=shard, num_shards=2,
              crop_mode=crop_mode, in_radius=1.0, sampler=sampler)
    bj = list(js.make_batch_iterator(dj, 1, 1024, transform=jt.default_train_transform(), **kw))
    bt = list(ts.make_batch_iterator(dt, 1, 1024, transform=tt.default_train_transform(), **kw))
    assert len(bj) == len(bt) == 3
    assert_same(bj, bt)
    assert bt[0]["points"].shape == (1, 1024, 3) and bt[0]["labels"].dtype == np.int32


def test_prefetch_keeps_order_and_reraises():
    assert list(tpf.prefetch(lambda: iter(range(20)), depth=2)) == list(range(20))

    def failing():
        yield 1
        yield 2
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for x in tpf.prefetch(failing, depth=1):
            got.append(x)
    assert got == [1, 2]
    assert list(jpf.prefetch(lambda: iter(range(5)))) == list(tpf.prefetch(lambda: iter(range(5))))


def _frozen_train_batch(dataset, batch_size, n_points, rng, voxel_size=0.04, voxel_max=80_000):
    """train_batch as it was before the data pipeline was ported (its own
    voxelize and crop), kept here to pin the batches."""
    out = {"points": [], "features": [], "labels": []}
    for _ in range(batch_size):
        coord, feat, label = dataset.room(int(rng.integers(dataset.num_rooms)))
        coord = coord - coord.min(0)
        v = np.floor((coord - coord.min(0)) / voxel_size).astype(np.int64)
        dims = v.max(0) + 1
        key = (v[:, 0] * dims[1] + v[:, 1]) * dims[2] + v[:, 2]
        order = np.argsort(key, kind="stable")
        _, starts, counts = np.unique(key[order], return_index=True, return_counts=True)
        pick = order[starts + rng.integers(0, counts)]
        coord, feat, label = coord[pick], feat[pick], label[pick]
        if len(coord) > voxel_max:
            d2 = ((coord - coord[rng.integers(len(coord))]) ** 2).sum(1)
            crop = np.argpartition(d2, voxel_max - 1)[:voxel_max]
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


@pytest.mark.parametrize("voxel_max,n_points", [(1500, 1024), (1500, 2048), (80_000, 2048)])
def test_train_batch_is_pinned(voxel_max, n_points):
    ds = tsyn.SyntheticSceneDataset(**ROOM)
    same_draws(lambda r: _frozen_train_batch(ds, 3, n_points, r, 0.05, voxel_max),
               lambda r: tsyn.train_batch(ds, 3, n_points, r, 0.05, voxel_max), 6)
    assert tsyn.voxelize is tp.voxelize and tsyn.SyntheticSceneDataset is ts.SyntheticSceneDataset

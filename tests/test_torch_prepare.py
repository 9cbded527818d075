"""The port's offline data path against the JAX package's on the same raw
inputs, fabricated from seeds: the grid subsample (the C++ copy and its
numpy twin, each bit for bit the JAX package's route of the same kind) and
voxel_pick; every file the four preparers write, byte for byte; PLY files,
the mesh rasterizer, the label maps, each dataset's rooms, the submission
files and the calibration integers, exactly; and ``--mode calibrate``,
which logs the JAX package's caps (no model is built on either side)."""
import filecmp
import logging
import os
import stat
import zipfile

import numpy as np
import pytest

from contrastboundary_tpu import native as jnative
from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.data import calibrate as jcal
from contrastboundary_tpu.data import datasets as jds
from contrastboundary_tpu.data import ingest as jingest
from contrastboundary_tpu.data import prepare as jprep
from contrastboundary_tpu.data import prepare_scannet as jscannet
from contrastboundary_tpu.main import calibrate as jax_calibrate
from contrastboundary_tpu.utils import mesh as jmesh
from contrastboundary_tpu.utils import ply as jply
from contrastboundary_tpu.utils import storage as jstorage

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu_torch import native
from contrastboundary_tpu_torch.data import calibrate as tcal
from contrastboundary_tpu_torch.data import datasets as tds
from contrastboundary_tpu_torch.data import ingest as tingest
from contrastboundary_tpu_torch.data import prepare as tprep
from contrastboundary_tpu_torch.data import prepare_scannet as tscannet
from contrastboundary_tpu_torch.data.synthetic import write_scannet_scene
from contrastboundary_tpu_torch.kernels import build
from contrastboundary_tpu_torch.utils import mesh as tmesh
from contrastboundary_tpu_torch.utils import ply as tply
from contrastboundary_tpu_torch.utils import storage as tstorage
from torch_raw_scans import write_npm3d_tree, write_s3dis_tree, write_semantic3d_tree

SCANNET_SMALL = dict(size=(2.0, 1.5, 1.0), n_boxes=3, cell=0.3)


def same(a, b):
    """Equal dtype, shape and bytes (None for None)."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_files(dir_a, dir_b):
    """Every file under the two trees, by relative path, byte for byte."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs)
    assert files(dir_a) == files(dir_b)
    _, mismatch, errors = filecmp.cmpfiles(dir_a, dir_b, files(dir_a), shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return files(dir_a)


# ---------------------------------------------------------------- grid subsample

def _cloud(seed, n=3000, fdim=4, label_lo=-2, num_classes=13):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * [3.0, 2.0, 1.0]).astype(np.float32)
    feats = rng.rand(n, fdim).astype(np.float32) if fdim else None
    labels = rng.randint(label_lo, num_classes, n).astype(np.int32)
    return pts, feats, labels


@pytest.mark.parametrize("case", ["features", "no features", "no labels", "every label ignored",
                                  "one point a voxel"])
def test_grid_subsample_equals_the_jax_routes_bit_for_bit(case):
    assert jnative.native_available()  # JAX's C++ route, not its numpy fallback
    pts, feats, labels = _cloud(0, fdim=0 if case == "no features" else 4)
    cell = 0.2
    if case == "no labels":
        labels = None
    if case == "every label ignored":
        labels = np.full(len(pts), -1, np.int32)
    if case == "one point a voxel":
        cell = 1e-3
    got_cpp = native.grid_subsample(pts, feats, labels, cell=cell, num_classes=13)
    ref_cpp = jnative.grid_subsample(pts, feats, labels, cell=cell, num_classes=13)
    got_np = native.grid_subsample_plain(pts, feats, labels, cell, 13)
    ref_np = jnative._grid_subsample_np(pts, feats, labels, cell, 13)
    for got, ref in ((got_cpp, ref_cpp), (got_np, ref_np)):
        assert all(same(g, r) for g, r in zip(got, ref))
    if case == "every label ignored":
        assert (got_cpp[2] == -1).all()
    assert len(got_cpp[0]) < len(pts) or case == "one point a voxel"


@pytest.mark.parametrize("salt", [0, 7, 2**40 + 3])
def test_voxel_pick_and_its_twin_equal_the_jax_kernel(salt):
    assert jnative.native_available()
    pts, _, _ = _cloud(1, n=2000, fdim=0)
    ref = jnative.voxel_pick(pts, 0.3, salt=salt)
    assert same(native.voxel_pick(pts, 0.3, salt=salt), ref)
    assert same(native.voxel_pick_plain(pts, 0.3, salt=salt), ref)
    v = np.floor((pts[ref] - pts.min(0)) / np.float32(0.3)).astype(int)
    assert len({tuple(x) for x in v}) == len(ref)  # one point a voxel


def test_host_library_is_built_from_the_port_source_into_build(monkeypatch, tmp_path):
    """g++ builds the port's own copy into _build/<hash>/; a failed build
    raises from grid_subsample (no numpy fallback)."""
    path = build.build_host()
    assert path.parent.parent == build.BUILD_ROOT and path.name == "libcbl_native.so"
    assert (build.CSRC / "grid_subsample.cpp").read_text().count("cbl_grid_subsample") == 1
    assert "grid_subsample.cpp" not in build.SOURCES  # not an nvcc source

    fake = tmp_path / "bin"
    fake.mkdir()
    for cxx in ("g++", "c++"):
        (fake / cxx).write_text("#!/bin/sh\necho 'error: broken compiler' >&2\nexit 1\n")
        (fake / cxx).chmod(stat.S_IRWXU)
    monkeypatch.setenv("PATH", str(fake))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="broken compiler"):
            native.grid_subsample(*_cloud(2, n=100))
        assert not any(p.is_file() for p in (tmp_path / "_build").rglob("*"))
    finally:
        native.library.cache_clear()


# ---------------------------------------------------------------- files and arrays

def test_ply_files_and_reads_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    n = 257
    arrays = [rng.random((n, 3)).astype(np.float32), rng.random(n),
              rng.integers(0, 256, (n, 3)).astype(np.uint8), rng.integers(-5, 40, n),
              rng.integers(0, 9, n).astype(np.uint16)]
    names = ["x", "y", "z", "scalar", "red", "green", "blue", "label", "class"]
    tply.write_ply(str(tmp_path / "t.ply"), arrays, names)
    jply.write_ply(str(tmp_path / "j.ply"), arrays, names)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got, ref = tply.read_ply(str(tmp_path / "j.ply")), jply.read_ply(str(tmp_path / "j.ply"))
    assert list(got) == list(ref) and all(same(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError):
        tply.write_ply(str(tmp_path / "bad.ply"), arrays, names[:-1])


def test_rasterize_mesh_equals_the_jax_package_from_the_same_seed():
    rng = np.random.default_rng(3)
    verts = rng.random((40, 3)) * 2
    faces = rng.integers(0, 40, (60, 3))
    attrs, flab = rng.random((40, 3)) * 255, rng.integers(0, 20, 60)
    assert same(tmesh.face_areas(verts, faces), jmesh.face_areas(verts, faces))
    for kw in (dict(vertex_attrs=attrs, face_labels=flab), dict(include_vertices=False), {}):
        got = tmesh.rasterize_mesh(verts, faces, 500.0, rng=np.random.default_rng(5), **kw)
        ref = jmesh.rasterize_mesh(verts, faces, 500.0, rng=np.random.default_rng(5), **kw)
        assert all(same(g, r) for g, r in zip(got, ref))


def test_storage_reshapes_as_the_jax_package():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    assert tstorage.dict_list(rows) == jstorage.dict_list(rows) == {"a": [1, 2], "b": ["x", "y"]}
    cols = {"a": [1, 2], "b": ["x", "y"]}
    assert tstorage.list_dict(cols) == jstorage.list_dict(cols) == rows
    assert tstorage.dict_list([]) == {} and tstorage.list_dict({}) == []


def test_label_maps_forward_and_inverse_equal_the_jax_package():
    raw = np.arange(-3, 45)
    for make in (lambda m: m.LabelMap(list(range(41)), [l for l in range(41)
                                                         if l not in m.SCANNET_RAW_IDS]),
                 lambda m: m.LabelMap(list(range(9)), [0]),
                 lambda m: m.LabelMap(list(range(10)), [0], ignore_index=-100)):
        got, ref = make(tds), make(jds)
        assert same(got(raw), ref(raw)) and got.num_classes == ref.num_classes
        idx = np.arange(got.num_classes)
        assert same(got.inverse(idx), ref.inverse(idx))
    assert tds.SCANNET_RAW_IDS == jds.SCANNET_RAW_IDS and tds.NPM3D_NAMES == jds.NPM3D_NAMES


def test_s3dis_preparer_writes_the_jax_files(tmp_path):
    raw = write_s3dis_tree(tmp_path / "raw", np.random.default_rng(0))
    got = tprep.prepare_s3dis(raw, str(tmp_path / "t"), verbose=False)
    ref = jprep.prepare_s3dis(raw, str(tmp_path / "j"), verbose=False)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(same_files(tmp_path / "t", tmp_path / "j")) == 3
    room = np.load(tmp_path / "t" / "Area_1_office_1.npy")
    assert set(np.unique(room[:, 6])) == {2.0, 8.0, 12.0}  # wall, chair, stairs → clutter
    assert tprep.prepare_s3dis(raw, str(tmp_path / "t"), verbose=False) == []  # done: skipped


def test_scannet_preparer_writes_the_jax_files(tmp_path):
    for i in range(2):
        write_scannet_scene(str(tmp_path / "raw"), f"scene000{i}_00", np.random.default_rng(i),
                            **SCANNET_SMALL)
    os.makedirs(tmp_path / "raw" / "scene0009_00")  # no mesh: skipped
    mesh = str(tmp_path / "raw" / "scene0000_00" / "scene0000_00_vh_clean_2.ply")
    assert same(tscannet._read_faces(mesh), jscannet._read_faces(mesh))
    got = tscannet.prepare_scannet(str(tmp_path / "raw"), str(tmp_path / "t"), density=300.0,
                                   verbose=False)
    jscannet.prepare_scannet(str(tmp_path / "raw"), str(tmp_path / "j"), density=300.0,
                             verbose=False)
    assert len(got) == 2 and len(same_files(tmp_path / "t", tmp_path / "j")) == 2
    labels = mesh[:-4] + ".labels.ply"
    assert same(tscannet.convert_scene(mesh, labels, 100.0, np.random.default_rng(9)),
                jscannet.convert_scene(mesh, labels, 100.0, np.random.default_rng(9)))


def test_semantic3d_and_npm3d_ingest_write_the_jax_files(tmp_path):
    s3d = write_semantic3d_tree(tmp_path / "s3d", np.random.default_rng(1), n=1500)
    npm = write_npm3d_tree(tmp_path / "npm", np.random.default_rng(2), n=1500)
    for prep, jprep_, raw in ((tingest.prepare_semantic3d, jingest.prepare_semantic3d, s3d),
                              (tingest.prepare_npm3d, jingest.prepare_npm3d, npm)):
        name = os.path.basename(raw)
        got = prep(raw, str(tmp_path / "t" / name), verbose=False)
        assert got == jprep_(raw, str(tmp_path / "j" / name), verbose=False)
        assert len(got["train"]) == 2 and len(got["test"]) == 1
        files = same_files(tmp_path / "t" / name, tmp_path / "j" / name)
        assert sum(f.endswith("_proj.npy") for f in files) == 1  # the test scan's
    test = tmp_path / "t" / "s3d" / "test"
    proj = tingest.load_test_projection(str(test), "marketsquarefeldkirch_4")
    assert proj.shape == (1500,) and proj.max() < len(np.load(test / "marketsquarefeldkirch_4.npy"))


def test_each_dataset_gives_the_jax_rooms(tmp_path):
    rng = np.random.default_rng(4)
    scannet = tmp_path / "scannet"
    scannet.mkdir()
    for i in range(3):
        room = np.concatenate([rng.random((200, 6)), rng.integers(-1, 45, (200, 1))], 1)
        np.save(scannet / f"scene000{i}_00.npy", room.astype(np.float32))
    write_semantic3d_tree(tmp_path / "s3d_raw", np.random.default_rng(5), n=600)
    tingest.prepare_semantic3d(str(tmp_path / "s3d_raw"), str(tmp_path / "s3d"), verbose=False)
    write_npm3d_tree(tmp_path / "npm_raw", np.random.default_rng(6), n=600)
    tingest.prepare_npm3d(str(tmp_path / "npm_raw"), str(tmp_path / "npm"), verbose=False)
    cases = [("ScanNetDataset", str(scannet), dict(split="train", loop=2)),
             ("ScanNetDataset", str(scannet), dict(split="val", val_list=["scene0001_00"])),
             ("ScanNetDataset", str(scannet), dict(split="train", val_list=["scene0001_00"])),
             ("Semantic3DDataset", str(tmp_path / "s3d"), dict(split="train", loop=3)),
             ("Semantic3DDataset", str(tmp_path / "s3d"), dict(split="test")),
             ("NPM3DDataset", str(tmp_path / "npm"), dict(split="val")),
             ("NPM3DDataset", str(tmp_path / "npm"), dict(split="test"))]
    for cls, root, kw in cases:
        got, ref = getattr(tds, cls)(root, **kw), getattr(jds, cls)(root, **kw)
        assert got.names == ref.names and len(got) == len(ref) and got.num_rooms == ref.num_rooms
        for i in range(len(got)):
            assert all(same(g, r) for g, r in zip(got.room(i), ref.room(i))), (cls, kw, i)
        if kw["split"] == "test":
            for name in got.names:
                assert same(got.projection(name), ref.projection(name))
                assert same(tds.raw_projection(got, name), ref.projection(name))
    assert tds.raw_projection(tds.ScanNetDataset(str(scannet)), "scene0000_00") is None


def test_submission_files_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(7)
    preds8 = {"scan_a": rng.integers(0, 8, 500), "scan_b": rng.integers(0, 8, 37)}
    preds9 = {"scan_a": rng.integers(0, 9, 500), "scan_b": rng.integers(0, 9, 37)}
    zt = tds.Semantic3DDataset.write_submission(str(tmp_path / "t3"), preds8)
    zj = jds.Semantic3DDataset.write_submission(str(tmp_path / "j3"), preds8)
    with zipfile.ZipFile(zt) as a, zipfile.ZipFile(zj) as b:
        assert a.namelist() == b.namelist() == ["scan_a.labels", "scan_b.labels"]
        assert all(a.read(n) == b.read(n) for n in a.namelist())
        assert [i.compress_type for i in a.infolist()] == [i.compress_type for i in b.infolist()]
    os.remove(zt), os.remove(zj)
    same_files(tmp_path / "t3", tmp_path / "j3")
    got = tds.NPM3DDataset.write_submission(str(tmp_path / "tn"), preds9)
    ref = jds.NPM3DDataset.write_submission(str(tmp_path / "jn"), preds9)
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in ref]
    same_files(tmp_path / "tn", tmp_path / "jn")


def test_calibration_integers_equal_the_jax_package():
    rng = np.random.default_rng(8)
    clouds = [(rng.random((n, 3)) * [3, 3, 1.5]).astype(np.float32) for n in (3000, 2000, 5)]
    kw = dict(radii=[0.1, 0.2, 0.4], voxel_sizes=[0.04, 0.08, 0.16])
    assert tcal.calibrate_neighborhood_limits(clouds, **kw) == \
        jcal.calibrate_neighborhood_limits(clouds, **kw)
    assert tcal.calibrate_neighborhood_limits(clouds, keep_ratio=0.5, max_clouds=2, **kw) == \
        jcal.calibrate_neighborhood_limits(clouds, keep_ratio=0.5, max_clouds=2, **kw)
    for args in ((0.5, 0.04), (1.0, 0.1)):
        got = tcal.calibrate_crop_points(clouds, *args)
        assert got == jcal.calibrate_crop_points(clouds, *args)
    with pytest.raises(ValueError):
        tcal.calibrate_crop_points([clouds[2][:1]], 0.5, 0.04)


@pytest.mark.parametrize("preset", ["scannet_pt_cbl", "semantic3d_conv_cbl"])
def test_calibrate_mode_logs_the_jax_caps(preset, tmp_path, monkeypatch):
    """main --mode calibrate on prepared rooms logs what the JAX package's
    calibrate(cfg, logger) logs; under a ConvNet preset the neighbour caps
    too, with no ConvNet model built."""
    if preset == "scannet_pt_cbl":
        for i in range(2):
            write_scannet_scene(str(tmp_path / "raw"), f"scene000{i}_00",
                                np.random.default_rng(i), **SCANNET_SMALL)
        tscannet.prepare_scannet(str(tmp_path / "raw"), str(tmp_path / "data"), density=400.0,
                                 verbose=False)
    else:
        write_semantic3d_tree(tmp_path / "raw", np.random.default_rng(3), n=2000)
        tingest.prepare_semantic3d(str(tmp_path / "raw"), str(tmp_path / "data"), verbose=False)
    sets = f"data.data_root:{tmp_path / 'data'}"

    def no_model(*a, **kw):
        raise AssertionError("calibrate built a model or a pyramid")

    from contrastboundary_tpu_torch.config.base import Config
    monkeypatch.setattr(Config, "build_model", no_model)
    monkeypatch.setattr(Config, "pyramid_spec", no_model)
    n_points = entry.main(["-c", preset, "--mode", "calibrate", "--device", "cpu", "--set", sets,
                           "--exp_dir", str(tmp_path / "exp")])
    log = (tmp_path / "exp" / "log_calibrate.txt").read_text()

    records = []
    logger = logging.getLogger(f"jax_calibrate_{preset}")
    logger.addHandler(type("H", (logging.Handler,), {"emit": lambda s, r: records.append(
        r.getMessage())})())
    logger.setLevel(logging.INFO)
    ref = jax_calibrate(jax_load_config(preset, sets), logger)
    assert n_points == ref and records
    for line in records:
        assert line in log, line
    assert ("neighborhood_limits" in log) == (preset == "semantic3d_conv_cbl")

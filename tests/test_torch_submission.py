"""``--mode test`` of the port's entry point on the CPU (``--device cpu``):
a Semantic3D tree fabricated from a seed and prepared by data/ingest.py
(one labelled scan to train on, one unlabelled test scan of 3,000 raw
points), one ``--mode train`` step of a small point transformer over
semantic3d_conv_cbl (sorted layout, strided sampler, planes 16…256, one
block a stage, N = 2048), then ``--mode test --model_path auto``:

- the submission zip holds one raw label in 1–8 for each raw test point;
- its file equals, byte for byte, the composition by hand of the port's
  VotingEvaluator (the same seed, smoothing 0.98) on the restored model,
  ``ev.proj``, the scan's raw projection and the inverse label map;
- without the projection file, the npy-level predictions are submitted.

Voting itself is held to JAX's by the eval tests; no JAX model is compiled.
"""
import io
import os
import zipfile

import numpy as np
import pytest
import torch

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.data.datasets import Semantic3DDataset
from contrastboundary_tpu_torch.data.ingest import prepare_semantic3d
from contrastboundary_tpu_torch.eval.run import zero_labels
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
from torch_raw_scans import write_semantic3d_tree

TEST_SCAN, RAW_POINTS = "marketsquarefeldkirch_4", 3000
SETS = ("model.arch:pointtransformer;model.layout:sorted;model.sampler:strided;"
        "model.base_fdim:32;model.planes:[16,32,64,128,256];model.blocks:[1,1,1,1,1];"
        "data.n_points:2048;data.voxel_max:3000;optim.batch_size:1;optim.epochs:1;"
        "data.loop:1;eval.batch_size:2;log_freq:1")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """Each test worker computes with one thread: the suite runs six
    workers at once, and more threads each only oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(tmp, mode, *extra, votes):
    sets = f"data.data_root:{tmp / 'data'};{SETS};eval.num_votes:{votes}"
    return entry.main(["-c", "semantic3d_conv_cbl", "--mode", mode, "--device", "cpu",
                       "--set", sets, "--exp_dir", str(tmp / "exp"), *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("submission")
    write_semantic3d_tree(tmp / "raw", np.random.default_rng(11), train=("bildstein_1",),
                          test=(TEST_SCAN,), n=RAW_POINTS)
    prepare_semantic3d(str(tmp / "raw"), str(tmp / "data"), verbose=False)
    run(tmp, "train", votes=0)  # one step, no eval request
    assert "epoch 0 step 1/1:" in (tmp / "exp" / "log_train.txt").read_text()
    return tmp


def test_test_mode_submits_the_voted_predictions_of_every_raw_point(trained, monkeypatch):
    tmp = trained
    built = []
    real_setup = entry.setup

    def setup(*args, **kw):
        built.append(real_setup(*args, **kw))
        return built[-1]

    monkeypatch.setattr(entry, "setup", setup)
    zpath = run(tmp, "test", "--model_path", "auto", "--out_dir", str(tmp / "sub"), votes=0.3)
    assert zpath == str(tmp / "sub" / "submission.zip")
    with zipfile.ZipFile(zpath) as z:
        assert z.namelist() == [f"{TEST_SCAN}.labels"]
        text = z.read(f"{TEST_SCAN}.labels")
    raw = np.loadtxt(io.BytesIO(text), dtype=np.int64)
    assert raw.shape == (RAW_POINTS,) and raw.min() >= 1 and raw.max() <= 8

    # by hand: the restored model's votes, the room's points, the raw points, raw ids
    (model, spec, *_), = built
    cfg = load_config("semantic3d_conv_cbl", f"data.data_root:{tmp / 'data'};{SETS}")
    step = make_eval_step(model, spec, "cpu", num_classes=8)

    def predict(batch):
        return step(zero_labels(batch))[0].numpy()

    test_ds = Semantic3DDataset(str(tmp / "data"), split="test")
    ev = VotingEvaluator(test_ds, predict, 8, 2048, batch_size=2, voxel_size=0.06,
                         num_votes=0.3, smooth=0.98, seed=cfg.seed, crop_mode="radius",
                         in_radius=3.0)
    ev.run()
    pred = ev.clouds[0].predictions()[ev.proj[0]][test_ds.projection(TEST_SCAN)]
    expected = io.BytesIO()
    np.savetxt(expected, test_ds.label_map.inverse(pred), fmt="%d")
    assert text == expected.getvalue()

    # without the projection file: the room's (npy-level) predictions
    os.remove(tmp / "data" / "test" / f"{TEST_SCAN}_proj.npy")
    zpath = run(tmp, "test", "--model_path", "auto", votes=0.3)
    assert zpath == str(tmp / "exp" / "submission" / "submission.zip")
    with zipfile.ZipFile(zpath) as z:
        npy_level = np.loadtxt(io.BytesIO(z.read(f"{TEST_SCAN}.labels")), dtype=np.int64)
    assert npy_level.shape == (len(test_ds.room(0)[0]),)
    assert np.array_equal(npy_level, test_ds.label_map.inverse(ev.clouds[0].predictions()[
        ev.proj[0]]))
    assert "no raw projection file" in (tmp / "exp" / "log_test.txt").read_text()

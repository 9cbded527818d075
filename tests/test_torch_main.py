"""The port's training entry point, ``python -m contrastboundary_tpu_torch.main``,
on the CPU (``--device cpu``) at a small size: the flagship preset at
planes (16, 32, 64, 128, 256), one block a stage, N = 2048, over .npy rooms
of 3,000 points written here (two train rooms, one val room), with one
torch thread (the suite runs six workers at once on the machine's cores).

- ``--mode train``, 2 steps and the epoch-end voting eval: the losses it
  records equal, bit for bit, those of make_train_step applied by hand to
  make_batch_iterator's batches from the same seed, flax-like init and
  schedule; the snapshot holds the hand-trained model's and optimizer's
  state bit for bit.
- ``--mode val`` restores that snapshot exactly and evaluates it;
  ``extra_ops`` 'boundary-save' writes the eval h5 that ``--mode analyze``
  re-reads to the same boundary numbers.
- A NaN in a room's colours raises FloatingPointError and writes
  ``nan_dump.pkl``; ``--mode check`` logs its histograms; without CUDA and
  without ``--device cpu`` the entry raises (modes check, calibrate and
  test), and a ConvNet preset with an option the port lacks
  (s3dis_randla_cbl in bfloat16) raises NotImplementedError naming ROADMAP
  item 7 at ``--mode train``.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.data import (
    S3DISDataset, SyntheticSceneDataset, default_train_transform, make_batch_iterator,
)
from contrastboundary_tpu_torch.train import (
    TrainStepConfig, make_optimizer, make_train_step, multistep_epoch_decay, set_learning_rate,
)
from contrastboundary_tpu_torch.utils import read_scalars

ROOM_POINTS = 3000  # few crops a vote round and enumeration pass
SETS = ("optim.batch_size:1;optim.epochs:1;data.loop:1;eval.num_votes:0.5;eval.batch_size:2;"
        "data.n_points:2048;data.voxel_max:3000;model.planes:[16,32,64,128,256];"
        "model.blocks:[1,1,1,1,1];log_freq:1")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """Every worker of the suite computes with torch's default of one thread
    a core: six of them oversubscribe the cores many times over, and this
    file's steps, votes and passes wait on each other's threads. One thread
    here; the default is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_rooms(root, nan_room=False):
    os.makedirs(root, exist_ok=True)
    for split, area, n in (("train", 1, 2), ("val", 5, 1)):
        rooms = SyntheticSceneDataset(num_rooms=n, points_per_room=ROOM_POINTS, seed=1,
                                      split=split)
        for i in range(n):
            c, f, l = rooms.room(i)
            if nan_room and split == "train":
                f[:50] = np.nan
            np.save(os.path.join(root, f"Area_{area}_room_{i}.npy"),
                    np.concatenate([c, f, l[:, None]], 1).astype(np.float32))
    return str(root)


def run(tmp, mode, *extra, data="data", exp="exp"):
    sets = f"data.data_root:{tmp / data};{SETS}"
    return entry.main(["-c", "s3dis_pt_cbl", "--mode", mode, "--device", "cpu", "--set", sets,
                       "--exp_dir", str(tmp / exp), *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    write_rooms(tmp / "data")
    best = run(tmp, "train")
    return tmp, best


def by_hand(tmp):
    """Two steps of make_train_step on make_batch_iterator's batches, set up
    as the entry sets up the preset → (losses, model, optimizer)."""
    cfg = load_config("s3dis_pt_cbl", f"data.data_root:{tmp / 'data'};{SETS}")
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(cfg.seed))
    ds = S3DISDataset(cfg.data.data_root, "train", loop=1)
    o = cfg.optim
    schedule = multistep_epoch_decay(o.base_lr, [m * o.epochs for m in o.milestones],
                                     o.multiplier, len(ds) // o.batch_size)
    opt = make_optimizer(model.parameters(), schedule, momentum=o.momentum,
                         weight_decay=o.weight_decay)
    step = make_train_step(model, TrainStepConfig(13, cfg.pyramid_spec(), cfg.contrast),
                           opt, device="cpu")
    losses = []
    for t, batch in enumerate(make_batch_iterator(
            ds, o.batch_size, cfg.data.n_points, seed=cfg.seed, epoch=0,
            transform=default_train_transform(), voxel_size=cfg.data.voxel_size,
            voxel_max=cfg.data.voxel_max)):
        set_learning_rate(opt, schedule, t)
        losses.append(float(step(batch)["loss"]))
    return losses, model, opt


def test_train_losses_equal_the_train_step_by_hand(trained):
    tmp, best = trained
    series = read_scalars(str(tmp / "exp" / "scalars.jsonl"))
    steps, losses = series["train/loss"]
    ref, model, opt = by_hand(tmp)
    assert steps == [1, 2] and len(ref) == 2
    assert losses == ref  # bit for bit: float32 → JSON → float is exact
    assert all(np.isfinite(losses))
    assert 0.0 <= best <= 1.0 and series["val/mIoU"][1] == [best]
    snap = torch.load(tmp / "exp" / "checkpoints" / "snap-2", map_location="cpu",
                      weights_only=True)
    assert snap["step"] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(snap["model"][k], v), k
    for i, state in opt.state_dict()["state"].items():
        assert torch.equal(snap["optimizer"]["state"][i]["momentum_buffer"],
                           state["momentum_buffer"]), i
    with open(tmp / "exp" / "checkpoints" / "best.json") as f:
        assert f.read().startswith('{"step": 2')
    assert "training done" in (tmp / "exp" / "log_train.txt").read_text()


def test_val_restores_the_snapshot_exactly_and_analyze_rereads_it(trained, monkeypatch):
    tmp, _ = trained
    built = []
    real_setup = entry.setup

    def setup(*args, **kw):
        out = real_setup(*args, **kw)
        built.append(out)
        return out

    monkeypatch.setattr(entry, "setup", setup)
    m = run(tmp, "val", "--model_path", "auto", "--extra_ops", "boundary-save")
    (model, _, _, opt, *_), = built
    snap = torch.load(tmp / "exp" / "checkpoints" / "snap-2", map_location="cpu",
                      weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(snap["model"][k], v), k
    for i, state in opt.state_dict()["state"].items():
        assert torch.equal(snap["optimizer"]["state"][i]["momentum_buffer"],
                           state["momentum_buffer"]), i
    assert 0.0 <= m["full"]["mIoU"] <= 1.0 and 0.0 <= m["boundary"]["B-IoU"] <= 1.0
    h5 = tmp / "exp" / "val_2.h5"
    assert h5.exists()
    again = run(tmp, "analyze", "--h5", str(h5), "--extra_ops", "boundary")
    assert again["boundary"]["B-IoU"] == m["boundary"]["B-IoU"]
    best = run(tmp, "val", "--model_path", "best", "--protocol", "enumerate", "--extra_ops", "")
    assert 0.0 <= best["full"]["OA"] <= 1.0


def test_nan_features_raise_and_dump(tmp_path):
    write_rooms(tmp_path / "nan", nan_room=True)
    with pytest.raises(FloatingPointError, match="NaN loss at step 1"):
        run(tmp_path, "train", data="nan")
    with open(tmp_path / "exp" / "nan_dump.pkl", "rb") as f:
        dump = pickle.load(f)
    assert dump["step"] == 1 and dump["report"]["batch/features"] > 0
    assert not (tmp_path / "exp" / "checkpoints" / "snap-1").exists()


def test_check_mode_logs_histograms(tmp_path):
    write_rooms(tmp_path / "data")
    run(tmp_path, "check")
    log = (tmp_path / "exp" / "log_check.txt").read_text()
    for what in ("ms/batch", "duplicate-pad fraction", "crop extent", "label histogram"):
        assert what in log, what


def test_entry_needs_cuda_unless_cpu_and_raises_for_a_convnet_preset(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("check", "calibrate", "test"):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.main(["-c", "s3dis_pt_cbl", "--mode", mode, "--exp_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 7"):
        entry.main(["-c", "s3dis_randla_cbl", "--mode", "train", "--device", "cpu",
                    "--set", "model.dtype:bfloat16", "--exp_dir", str(tmp_path)])

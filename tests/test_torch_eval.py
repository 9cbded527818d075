"""Port eval pieces against the JAX package: confusion and metrics, the
synthetic dataset and voxelize (same arrays from the same seed), and the
voting loop driven by one stub predictor in both packages."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.data.pipeline import voxelize as jax_voxelize
from contrastboundary_tpu.data.s3dis import SyntheticSceneDataset as JaxDataset
from contrastboundary_tpu.eval.metrics import AverageMeter as JaxMeter
from contrastboundary_tpu.eval.metrics import confusion_matrix as jax_confusion
from contrastboundary_tpu.eval.metrics import metrics_from_confusion as jax_metrics
from contrastboundary_tpu.eval.voting import VotingEvaluator as JaxVoting
from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset, voxelize
from contrastboundary_tpu_torch.eval.metrics import AverageMeter, confusion_matrix, metrics_from_confusion
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator


def test_confusion_and_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.randint(-1, 15, (3, 500)).astype(np.int32)  # out-of-range preds clip
    label = rng.randint(-1, 13, (3, 500)).astype(np.int32)  # -1 ignored
    conf = confusion_matrix(torch.as_tensor(pred), torch.as_tensor(label), 13)
    j_conf = np.asarray(jax_confusion(jnp.asarray(pred), jnp.asarray(label), 13))
    np.testing.assert_array_equal(conf.numpy(), j_conf)
    props = rng.rand(13) * 1000
    for p in (None, props):
        m, jm = metrics_from_confusion(conf.numpy(), p), jax_metrics(j_conf, p)
        for k in ("mIoU", "OA", "mACC", "IoUs", "confusion"):
            np.testing.assert_array_equal(m[k], jm[k])
    meter, jmeter = AverageMeter(), JaxMeter()
    for v, n in [(1.0, 2), (4.0, 1)]:
        meter.update(v, n)
        jmeter.update(v, n)
    assert meter.avg == jmeter.avg


def test_dataset_and_voxelize_match_jax():
    kw = dict(num_rooms=3, points_per_room=5000, seed=1, split="val", ignore_fraction=0.1)
    ds, jds = SyntheticSceneDataset(**kw), JaxDataset(**kw)
    assert ds.num_rooms == jds.num_rooms and len(ds) == len(jds)
    for r in range(3):
        for a, b in zip(ds.room(r), jds.room(r)):
            np.testing.assert_array_equal(a, b)
    coord = ds.room(0)[0]
    np.testing.assert_array_equal(
        voxelize(coord, 0.05, np.random.default_rng(3)),
        jax_voxelize(coord, 0.05, np.random.default_rng(3)),
    )
    for a, b in zip(voxelize(coord, 0.05, mode="val"), jax_voxelize(coord, 0.05, mode="val")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("crop_mode", ["count", "radius"])
def test_voting_matches_jax(crop_mode):
    def predict(batch):
        # a deterministic function of the crop: class from height and colour
        p, f = batch["points"], batch["features"]
        logits = np.stack([np.sin(p[..., 2] * (c + 1)) + f[..., c % 3] for c in range(13)], -1)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    kw = dict(num_rooms=2, points_per_room=6000, seed=0, split="val")
    ev_kw = dict(num_classes=13, n_points=1024, batch_size=2, voxel_size=0.08,
                 num_votes=0.5, crop_mode=crop_mode, in_radius=1.0)
    m = VotingEvaluator(SyntheticSceneDataset(**kw), predict, **ev_kw).run(max_steps=6)
    jm = JaxVoting(JaxDataset(**kw), predict, **ev_kw).run(max_steps=6)
    for split in ("sub", "full"):
        for k in ("mIoU", "OA", "mACC", "confusion"):
            np.testing.assert_array_equal(m[split][k], jm[split][k])

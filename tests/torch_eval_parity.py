"""Shared set-up of the port's eval tests (tests/test_torch_eval_step_features.py,
tests/test_torch_eval_protocols.py): the small float32 model of
tests/torch_bf16_parity.py (planes 16, 32, 64) from seeded flax weights,
JAX's feature eval step for it, compiled once a process, and the seeded
synthetic room that the protocols run over."""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import torch_bf16_parity as bp
from contrastboundary_tpu.data.s3dis import SyntheticSceneDataset as JaxDataset
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset
from contrastboundary_tpu_torch.models import load_jax_variables

B, N, NUM_CLASSES = 2, 1024, bp.NUM_CLASSES
SPEC = bp.SPEC
# two synthetic val rooms thinned to every second and every fourth point: at
# voxel 0.1 m each of the first room's 3 passes holds more than N points (one
# a voxel) and goes through the crop loop (7 parts), each of the second's
# fewer, and is padded by repetition (2 parts)
ROOM = dict(num_rooms=2, points_per_room=2200, seed=3, split="val")
THIN = (2, 4)
VOXEL = 0.1


@functools.lru_cache(maxsize=None)
def tree():
    return bp.seeded_tree(2)


def port_model(bn_mode="batch"):
    return load_jax_variables(bp.port_model(bn_mode, torch.float32), tree())


class OnGrid:
    """A dataset whose rooms, room i thinned to every THIN[i]-th point, have
    their coordinates rounded to multiples of 1/64 m, so that every squared
    distance of a crop is exact in float32 and the neighbour searches of
    both packages break the same ties (crops padded by repetition hold
    duplicated points)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.num_rooms = dataset.num_rooms

    def room(self, i):
        coord, feat, label = (a[::THIN[i]] for a in self.dataset.room(i))
        return np.round(coord * 64) / 64, feat, label


def datasets():
    """The room as the port's and as JAX's dataset (the same arrays)."""
    return OnGrid(SyntheticSceneDataset(**ROOM)), OnGrid(JaxDataset(**ROOM))


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax_make_eval_step(
        bp.jax_model("batch", jnp.float32),
        JaxStepConfig(num_classes=NUM_CLASSES, spec=bp.JAX_SPEC),
        with_features=True, output="logits")


def jax_features(batch):
    """JAX make_eval_step(with_features=True, output='logits') of the model
    on ``batch`` (points, features and, where given, labels) → (logits,
    confusion, {name: latent}) as numpy arrays. Eval-mode BN is the same
    function under batch and stale BN, so this serves both."""
    b = {k: jnp.asarray(batch[k]) for k in ("points", "features")}
    b["labels"] = jnp.asarray(batch.get("labels", np.zeros(np.shape(batch["points"])[:2],
                                                              np.int32)))
    state = bp._State(params=tree()["params"], batch_stats=tree()["batch_stats"])
    logits, conf, feats = jax.device_get(_jax_step()(state, b))
    return np.asarray(logits), np.asarray(conf), {k: np.asarray(v) for k, v in feats.items()}


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)

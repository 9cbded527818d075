"""flax variables ↔ PyTorch state_dict, and the repo's checkpoint pickles.

The port's modules carry the flax module names, so each flax leaf maps to one
state_dict key: ``params/<path>/kernel`` [in, out] → ``<path>.weight``
[out, in] (transposed), ``bias`` → ``bias``, BatchNorm ``scale`` →
``weight``, a KPConv's ``weights`` [P, C] → ``weights`` (as it is);
``batch_stats/<path>/mean`` → ``running_mean``, ``var`` → ``running_var``.
"""
from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight", "weights": "weights"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_INV_STATS = {v: k for k, v in _STAT_LEAVES.items()}


def _leaves(tree: Mapping, prefix=()):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (name,))
        else:
            yield prefix + (name,), v


def from_jax_variables(tree: Mapping) -> dict:
    """{"params", "batch_stats"} flax tree of numpy arrays → state_dict
    (float32 CPU tensors). Raises on a collection or leaf name it does not
    know, so no leaf is silently dropped."""
    unknown = set(tree) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections {sorted(unknown)}")
    out = {}
    for coll, names in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, v in _leaves(tree.get(coll, {})):
            *mod, leaf = path
            if leaf not in names:
                raise ValueError(f"unknown {coll} leaf {'/'.join(path)}")
            a = np.asarray(v, np.float32)
            if leaf == "kernel":
                a = a.T
            key = ".".join(mod + [names[leaf]])
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_jax_variables(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a flax tree into ``model``; raises if any flax leaf is left
    unconsumed, any model parameter or buffer is left unset, or a shape
    differs."""
    sd = from_jax_variables(tree)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(sd))
    unused = sorted(set(sd) - set(expected))
    if missing or unused:
        raise ValueError(f"unset in the model: {missing}; unconsumed leaves: {unused}")
    for key, v in sd.items():
        if tuple(v.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{key}: flax {tuple(v.shape)} vs model {tuple(expected[key].shape)}"
            )
    model.load_state_dict(sd, strict=True)
    return model


def flax_path(model: torch.nn.Module, key: str) -> tuple:
    """The flax path (collection, *modules, leaf) of a state_dict key, e.g.
    ('params', 'enc0_down', 'Dense_0', 'kernel') for
    'enc0_down.Dense_0.weight'."""
    *path, leaf = key.split(".")
    if leaf in _INV_STATS:
        return ("batch_stats", *path, _INV_STATS[leaf])
    if leaf in ("bias", "weights"):
        return ("params", *path, leaf)
    if leaf == "weight" and isinstance(model.get_submodule(".".join(path)), torch.nn.Linear):
        return ("params", *path, "kernel")
    if leaf == "weight":
        return ("params", *path, "scale")
    raise ValueError(f"no flax leaf for {key}")


def to_jax_variables(model: torch.nn.Module) -> dict:
    """The model's parameters and running statistics as a {"params",
    "batch_stats"} flax tree of float32 numpy arrays (the inverse of
    from_jax_variables: Linear weights transposed to kernels)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, v in model.state_dict().items():
        coll, *path, name = flax_path(model, key)
        a = v.detach().float().cpu().numpy().copy()  # not a view of the live tensor
        if name == "kernel":
            a = a.T
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and nothing else. The checkpoints name
    ``numpy._core.*`` (numpy ≥ 2); under numpy < 2 that module is
    ``numpy.core.*``."""

    def find_class(self, module, name):
        if module != "numpy" and not module.startswith("numpy."):
            raise pickle.UnpicklingError(f"refusing to load {module}.{name}")
        if module.startswith("numpy._core") and int(np.__version__.split(".")[0]) < 2:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """A checkpoint pickle of the JAX trainer ({"params", "batch_stats"}
    trees of numpy arrays) → that tree."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()

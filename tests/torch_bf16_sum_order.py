"""How far float32 sum order alone moves the bfloat16 batch-BN train step at
the sizes of tests/test_torch_bf16_model.py, and where the port's step sits.

    JAX_PLATFORMS=cpu python tests/torch_bf16_sum_order.py [--seeds 0 1 2]

For each seed s (weights bp.seeded_tree(s), crops bp.batch(5 + s)) it prints
each metric of the step and the distance of the parameters and batch
statistics after it, each as a fraction of JAX's own bfloat16-vs-float32
gap on the same inputs:
- port-jax: the port's step against JAX's, both as they are;
- port-jax32: against JAX's step with its bfloat16 reduce_sums taken in
  float32 (bp.float32_bf16_sums);
- port-ref: against JAX's step under bp.reference_sums (float32 bfloat16
  sums and float64 batch statistics), over that reference's own gap: the
  comparison tests/test_torch_bf16_model.py makes;
- port-port64: the port against itself with every BatchNorm's batch mean
  and E[x²] summed in float64, then cast to float32 (no port code other
  than that sum changes);
- jax-swap: JAX's step against JAX's step on the batch with its two clouds
  swapped (the same step in exact arithmetic, other float32 sums; no port
  code at all);
then the parameter leaves that carry most of the squared port-jax and
port-jax32 distances, with their shares.
"""
import argparse
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

import torch_bf16_parity as bp  # noqa: E402
from contrastboundary_tpu_torch.models import blocks, load_jax_variables  # noqa: E402
from test_torch_train import _leaves  # noqa: E402


def _float64_stats_forward(self, x):
    """models/blocks.py::BatchNorm.forward with the batch statistics' values
    summed in float64 (their gradient as the float32 version's)."""
    if not self.training:
        return _FORWARD(self, x)
    axes = tuple(range(x.ndim - 1))
    xd, xf = x.double(), x.float()
    mean32, sq32 = xf.mean(axes), (xf * xf).mean(axes)
    mean = mean32 + (xd.mean(axes).float() - mean32).detach()
    sq = sq32 + ((xd * xd).mean(axes).float() - sq32).detach()
    var = torch.clamp_min(sq - mean * mean, 0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x.float() - mean) * mul + self.bias


_FORWARD = blocks.BatchNorm.forward


def _port(tree, data, float64_stats=False):
    blocks.BatchNorm.forward = _float64_stats_forward if float64_stats else _FORWARD
    try:
        return bp.port_train_step(load_jax_variables(bp.port_model("batch", torch.bfloat16),
                                                     tree), data)
    finally:
        blocks.BatchNorm.forward = _FORWARD


def _jax(dtype, tree, data, sums=contextlib.nullcontext):
    with sums():
        return bp.jax_train_step("batch", dtype, tree, data)


def _largest_leaf(a, b):
    """(path, share) of the params leaf with the largest squared distance."""
    a, b = dict(_leaves(a[1]["params"])), dict(_leaves(b[1]["params"]))
    sq = {k: float(np.sum((a[k] - b[k]) ** 2)) for k in b}
    key = max(sq, key=sq.get)
    return key, sq[key] / sum(sq.values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    for seed in args.seeds:
        tree, data = bp.seeded_tree(seed), bp.batch(5 + seed)
        swapped = {k: np.ascontiguousarray(v[::-1]) for k, v in data.items()}
        jb, jf = _jax(jnp.bfloat16, tree, data), _jax(jnp.float32, tree, data)
        j32 = _jax(jnp.bfloat16, tree, data, bp.float32_bf16_sums)
        rb = _jax(jnp.bfloat16, tree, data, bp.reference_sums)
        rf = _jax(jnp.float32, tree, data, bp.reference_sums)
        jswap = _jax(jnp.bfloat16, tree, swapped)
        port, port64 = _port(tree, data), _port(tree, data, float64_stats=True)
        print(f"seed {seed} (weights {seed}, crops {5 + seed}); fractions of JAX's "
              "bf16-vs-f32 gap")
        print(f"  {'':12s} {'port-jax':>9s} {'port-jax32':>10s} {'port-ref':>9s} "
              f"{'port-port64':>11s} {'jax-swap':>9s}")
        rows = [(m, lambda a, b, m=m: abs(a[0][m] - b[0][m])) for m in bp.METRICS]
        rows += [(c, lambda a, b, c=c: bp.tree_dist(a[1], b[1], c))
                 for c in ("params", "batch_stats")]
        for name, dist in rows:
            gap, ref_gap = dist(jb, jf), dist(rb, rf)
            print(f"  {name:12s} {dist(port, jb) / gap:9.4f} {dist(port, j32) / gap:10.4f} "
                  f"{dist(port, rb) / ref_gap:9.4f} {dist(port, port64) / gap:11.4f} "
                  f"{dist(jswap, jb) / gap:9.4f}")
        for name, ref in (("port-jax", jb), ("port-jax32", j32)):
            leaf, share = _largest_leaf(port, ref)
            print(f"  {name}: {leaf} carries {share:.3f} of the squared parameter distance")


if __name__ == "__main__":
    main()

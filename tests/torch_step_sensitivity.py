"""How far float32 rounding alone moves the flagship train step at the small
width of tests/test_torch_train.py, and where the port's step sits.

    JAX_PLATFORMS=cpu python tests/torch_step_sensitivity.py [--seeds 0 1] [--no-cbl]

For each weight seed (the noise test_torch_train.py adds to flax's init)
it prints, for each of three steps:
- port: the distance of the port's step from JAX's step taken from the
  same state (test_torch_train.train_runs_for), over the norm of JAX's
  change in that step, for params and batch_stats;
- swap: JAX's own three-step run on the batches with their two clouds
  swapped (the same steps in exact arithmetic, other float32 sums) against
  the unswapped run, over the norm of the unswapped run's change so far;
then the ReLU inputs (BatchNorm outputs) whose sign differs between JAX's
first forward on the batch and on the swapped batch. ``--no-cbl`` runs
the swap comparison without the CBL term.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train as tt  # noqa: E402


def _vec(tree, collection):
    d = dict(tt._leaves(tree[collection]))
    return np.concatenate([d[k].ravel() for k in sorted(d)])


def _swapped(batch):
    return {k: v[::-1].copy() for k, v in batch.items()}


def _jax_run(jstep, tx, variables, batches):
    state = tt.create_train_state(jax.tree_util.tree_map(np.copy, variables), tx)
    out = []
    for batch in batches:
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append({"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats)})
    return out


def _relu_flips(jmodel, jspec, variables, batch):
    @jax.jit
    def bn_outputs(pts, feats):
        pyr = tt.jax_build_pyramid(pts, jspec)
        f = jnp.take_along_axis(feats, pyr.order0[..., None], 1)
        _, st = jmodel.apply(variables, f, pyr, train=True,
                             mutable=["batch_stats", "intermediates"], capture_intermediates=True)
        return st["intermediates"]

    a = bn_outputs(jnp.asarray(batch["points"]), jnp.asarray(batch["features"]))
    sw = _swapped(batch)
    b = bn_outputs(jnp.asarray(sw["points"]), jnp.asarray(sw["features"]))
    for (path, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                 jax.tree_util.tree_flatten_with_path(b)[0]):
        name = jax.tree_util.keystr(path)
        if "bn" not in name and "BatchNorm" not in name:
            continue
        x, y = np.asarray(x), np.asarray(y)[::-1]
        for ix in np.argwhere((x > 0) != (y > 0)):
            print(f"  ReLU flip {name} {x.shape} at {tuple(int(i) for i in ix)}: "
                  f"{x[tuple(ix)]:.3e} vs {y[tuple(ix)]:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--no-cbl", action="store_true")
    args = ap.parse_args()
    for seed in args.seeds:
        batches, jspec, jmodel, variables = tt.small_setup(seed)
        runs = tt.train_runs_for(seed)
        contrast = None if args.no_cbl else tt.JaxContrast()
        jstep = tt.jax_make_train_step(
            jmodel, tt.JaxStepConfig(num_classes=13, spec=jspec, contrast=contrast)
        )
        tx = tt.jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
        ref = _jax_run(jstep, tx, variables, batches)
        swap = _jax_run(jstep, tx, variables, [_swapped(b) for b in batches])
        for i, (before, _, port, _, jax_after) in enumerate(runs):
            cols = []
            for c in ("params", "batch_stats"):
                w = _vec(jax_after, c)
                cols.append(f"port {c} {np.linalg.norm(_vec(port, c) - w) / np.linalg.norm(w - _vec(before, c)):.3e}")
            for c in ("params", "batch_stats"):
                r = _vec(ref[i], c)
                cols.append(f"swap {c} {np.linalg.norm(_vec(swap[i], c) - r) / np.linalg.norm(r - _vec(variables, c)):.3e}")
            print(f"seed {seed} step {i + 1}: " + ", ".join(cols), flush=True)
        _relu_flips(jmodel, jspec, variables, batches[0])


if __name__ == "__main__":
    main()

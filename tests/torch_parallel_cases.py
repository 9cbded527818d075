"""The data-parallel cases of tests/test_torch_parallel.py, run by each
rank of a gloo group of CPU processes and, on the whole global batch, by
the test's own process at world size 1.

Each case takes this rank's rows of a global batch made from a seed
(``mine``) and returns numpy arrays; the test compares the ranks' results
(their rows stacked, or their sums, or each alone) with the world-size-1
results and with JAX's 2-device sharded step. Run as a script, it is one
rank: ``CBL_COORDINATOR``, ``CBL_NUM_PROCESSES`` and ``CBL_PROCESS_ID``
describe the group, and the results go to ``<out>/rank<r>.pkl``:

    python tests/torch_parallel_cases.py <out>
"""
import contextlib
import copy
import os
import pickle
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from contrastboundary_tpu_torch import parallel  # noqa: E402
from contrastboundary_tpu_torch.losses.contrast import (  # noqa: E402
    ContrastConfig, cbl_stage_loss, subscene_labels,
)
from contrastboundary_tpu_torch.losses.segmentation import (  # noqa: E402
    cross_entropy, sigmoid_cross_entropy,
)
from contrastboundary_tpu_torch.train.trainer import TrainStepConfig, main_loss  # noqa: E402
from contrastboundary_tpu_torch.models import (  # noqa: E402
    PointTransformerSeg, load_jax_variables, to_jax_variables,
)
from contrastboundary_tpu_torch.models.blocks import BatchNorm, StaleBatchNorm  # noqa: E402
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid  # noqa: E402
from contrastboundary_tpu_torch.train import (  # noqa: E402
    TrainStepConfig, make_optimizer, make_train_step,
)

# the tiny flagship's pyramid (__graft_entry__._flagship(256, tiny=True)), on
# clouds of 1024 points: at 256 its top level holds one point a cloud, and
# BatchNorm over the two rows of two clouds amplifies float32 sum order
# (swapping the clouds moves cbl_stage0 by 1e-2 at 256, by 1e-6 at 1024)
TINY_SPEC = PyramidSpec(strides=(1, 4, 4, 4, 4), k_self=(8,) * 5, k_down=(8,) * 5,
                        k_contrast=(8,) * 5, with_subscene=True, sampler="serialized",
                        layout="sorted")
FLAGSHIP_N, FLAGSHIP_BLOCKS = 1024, (1, 1, 1, 1, 1)  # full width, one block a level
LR = 0.05
BN_SHAPES = ((4, 64, 6), (4, 16, 8, 5))
CONV_SETS = "model.base_fdim:12;model.strides:[1,4,4]"
ROOM_POINTS = 3000
# loop 4: 8 crops an epoch, so 2 steps a rank at W = 2 and 4 at W = 1; the
# learning rate's one milestone at half the epoch falls inside the run
MAIN_SETS = ("optim.batch_size:2;optim.epochs:1;data.loop:4;optim.milestones:[0.5];"
             "eval.num_votes:0.3;eval.batch_size:2;data.n_points:2048;data.voxel_max:3000;"
             "model.planes:[16,32,64,128,256];model.blocks:[1,1,1,1,1];log_freq:1")


def mine(x):
    """This rank's rows of a global batch (all of them at world size 1)."""
    return parallel.local_rows({"x": x})["x"]


def host(t):
    return t.detach().cpu().numpy().copy()


def grid_clouds(b, n, seed):
    """b clouds of n points on the 1/64 m grid (every squared distance exact
    in float32, so the searches break ties alike everywhere), with features
    and labels, some ignored."""
    from torch_parity import synthetic_crops

    pts, feats, labels = synthetic_crops(b, n, seed=seed)
    labels[:, ::37] = -1
    return {"points": pts, "features": feats, "labels": labels}


def perturbed_tree(model, seed):
    """``model``'s flax tree moved by seeded noise of 0.02 (variances drawn
    in [0.5, ∞)), off the ReLU kinks of flax's zero biases. (Noise of 0.1,
    tests/test_torch_train.py's at width 16, is twice the σ of a 512-wide
    kernel: JAX's own sharded and unsharded steps then differ by 2.5% of the
    update at full width, by 1.8e-5 at 0.02.)"""
    rng = np.random.RandomState(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else (np.abs(rng.randn(*v.shape)) + 0.5).astype(np.float32) if k == "var"
                else (np.asarray(v) + 0.02 * rng.randn(*v.shape)).astype(np.float32)
                for k, v in t.items()}
    tree = to_jax_variables(model)
    return {"params": walk(tree["params"]), "batch_stats": walk(tree["batch_stats"])}


def calibrated_tree(tree, batch):
    """``tree`` with its BN statistics those of a train-mode forward over
    ``batch`` (a stale model normalizes with its running statistics, which
    must fit the activations of its weights)."""
    model = load_jax_variables(PointTransformerSeg(num_classes=13, blocks=FLAGSHIP_BLOCKS), tree)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
    pyr = build_pyramid(torch.as_tensor(batch["points"]), TINY_SPEC)
    with torch.no_grad():
        model.train()(torch.gather(torch.as_tensor(batch["features"]), 1,
                                   pyr.order0[..., None].expand(-1, -1, 3)), pyr)
    return to_jax_variables(model)


def momentum_tree(model, optimizer):
    """SGD's momentum buffers as a flax params tree (zeros before the first
    step, as optax's trace state starts)."""
    mom = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), mom.parameters()):
            q.copy_(optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p)))
    return to_jax_variables(mom)["params"]


@contextlib.contextmanager
def cbl_route(dense: str, impl: str = "xla"):
    with mock.patch.dict(os.environ, {"CBL_DENSE": dense}):
        yield ContrastConfig(impl=impl)


def bn_cases():
    """BatchNorm and StaleBatchNorm in train mode on [B, N, C] and
    [B, N, K, C]: output, input gradient of Σ y·g, parameter gradients (this
    rank's part), running statistics."""
    out = {}
    for cls in (BatchNorm, StaleBatchNorm):
        for shape in BN_SHAPES:
            rng = np.random.RandomState(len(shape))
            c = shape[-1]
            x = torch.as_tensor((rng.randn(*shape) * 3 + 1).astype(np.float32))
            g = torch.as_tensor(rng.randn(*shape).astype(np.float32))
            bn = cls(c)
            with torch.no_grad():
                bn.weight.copy_(torch.as_tensor(1 + 0.1 * rng.randn(c)))
                bn.bias.copy_(torch.as_tensor(0.1 * rng.randn(c)))
                bn.running_mean.copy_(torch.as_tensor(0.1 * rng.randn(c)))
                bn.running_var.copy_(torch.as_tensor(rng.rand(c) + 0.5))
            xl = mine(x).clone().requires_grad_(True)
            y = bn.train()(xl)
            (y * mine(g)).sum().backward()
            out[f"{cls.__name__}{len(shape)}"] = {
                "y": host(y), "dx": host(xl.grad), "dweight": host(bn.weight.grad),
                "dbias": host(bn.bias.grad), "running_mean": host(bn.running_mean),
                "running_var": host(bn.running_var)}
    return out


def loss_inputs():
    """Inputs of the loss means over 4 clouds of 256 points: logits and
    labels; stage 0 of the tiny flagship pyramid (window-relative contrast
    neighbours) with its soft labels; global-row neighbours (the natural
    layout's, M the shadow) with random soft labels (a few rows without
    mass); random features."""
    batch = grid_clouds(4, 256, seed=11)
    rng = np.random.RandomState(12)
    pyr = build_pyramid(torch.as_tensor(batch["points"]), TINY_SPEC)
    labels = torch.as_tensor(batch["labels"]).long()
    labels0 = torch.gather(labels, 1, pyr.order0)
    m = labels.shape[1]
    soft = rng.rand(4, m, 13) ** 4 * (rng.rand(4, m, 1) > 0.05)
    return {
        "logits": torch.as_tensor(rng.randn(4, m, 13).astype(np.float32)),
        "labels": labels,
        "features": torch.as_tensor(rng.randn(4, m, 16).astype(np.float32)),
        "label_soft": subscene_labels(labels0, pyr.subscene_idx[0], 13),
        "contrast_idx": pyr.contrast_idx[0], "local": pyr.contrast_local[0],
        "global_soft": torch.as_tensor((soft / np.maximum(soft.sum(-1, keepdims=True), 1e-9))
                                       .astype(np.float32)),
        "global_idx": torch.as_tensor(rng.randint(0, m + 1, (4, m, 8)).astype(np.int64)),
    }


def loss_cases():
    """Each of the loss means (cross-entropy, with class weights too; the
    plain head's sigmoid cross-entropy on binary labels; the CBL tile and
    global routes, cnt and kl; the v2 route; the dense route) → this rank's
    share of the global loss and the gradient of its input rows."""
    inp = loss_inputs()
    out = {}

    def run(name, fn, x):
        xl = mine(x).clone().requires_grad_(True)
        loss = fn(xl)
        loss.backward()
        out[name] = {"loss": host(loss), "grad": host(xl.grad)}

    labels = mine(inp["labels"])
    run("ce", lambda x: cross_entropy(x, labels), inp["logits"])
    weighted = TrainStepConfig(num_classes=13, spec=TINY_SPEC,
                               class_weights=tuple(np.linspace(0.5, 2.0, 13)))
    run("ce_class", lambda x: main_loss(weighted, x, labels), inp["logits"])
    binary = torch.where(labels >= 0, labels % 2, labels)
    run("sigmoid", lambda x: sigmoid_cross_entropy(x, binary), inp["logits"][..., :1])
    soft, cidx = mine(inp["label_soft"]), mine(inp["contrast_idx"])
    gsoft, gidx = mine(inp["global_soft"]), mine(inp["global_idx"])
    for pos in ("cnt", "kl"):
        cfg = ContrastConfig(pos=pos)
        run(f"cbl_global_{pos}", lambda x: cbl_stage_loss(x, gidx, gsoft, cfg, None),
            inp["features"])
    for name, dense, impl in (("cbl_tile", "off", "xla"), ("cbl_v2", "off", "pallas"),
                              ("cbl_dense", "on", "xla")):
        with cbl_route(dense, impl) as cfg:
            run(name, lambda x: cbl_stage_loss(x, cidx, soft, cfg, inp["local"]),
                inp["features"])
    return out


def conv_case():
    """One ConvNet train step (synthetic_conv_tiny, small widths) on 2 grid
    clouds of 512 points → the global metrics and the updated state."""
    from contrastboundary_tpu_torch.config import load_config

    cfg = load_config("synthetic_conv_tiny", CONV_SETS)
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(0))
    parallel.replicate(model)
    step = make_train_step(model, TrainStepConfig(num_classes=13, spec=cfg.pyramid_spec(),
                                                  contrast=cfg.contrast),
                           make_optimizer(model.parameters(), LR), device="cpu")
    batch = grid_clouds(2, 512, seed=21)
    metrics = step({k: mine(v) for k, v in batch.items()})
    return {"metrics": {k: host(v) for k, v in metrics.items()},
            "state": {k: host(v) for k, v in model.state_dict().items()}}


# the batches of the flagship steps: two under batch BN; one under stale BN,
# whose model normalizes with statistics calibrated on that batch
# (``calibrated_tree``): at full width they fit neither another batch's
# crops nor the weights after an update at lr 0.05 (the loss grows ~1e8)
STEP_SEEDS = {"batch": (31, 32), "stale": (31,)}


def flagship_trees(seed=0):
    """The flax trees the flagship steps start from: flax's init from
    ``seed``, perturbed; under stale BN with the statistics of the first
    step's batch."""
    from contrastboundary_tpu_torch.models.init import init_like_flax

    model = init_like_flax(PointTransformerSeg(num_classes=13, blocks=FLAGSHIP_BLOCKS),
                           torch.Generator().manual_seed(seed))
    tree = perturbed_tree(model, seed)
    first = grid_clouds(2, FLAGSHIP_N, seed=STEP_SEEDS["stale"][0])
    return {"batch": tree, "stale": calibrated_tree(tree, first)}


def flagship_steps(tree, bn_mode):
    """The tiny-flagship train steps of STEP_SEEDS (full width, one block a level, CE +
    5-stage CBL on the dense route, SGD lr 0.05), each on 2 grid clouds of
    FLAGSHIP_N points, from the flax tree ``tree`` → for each step its
    batch, the state before it (flax trees of the parameters, statistics
    and momentum), its global metrics, the state after it, and the
    collectives it issued."""
    model = load_jax_variables(
        PointTransformerSeg(num_classes=13, blocks=FLAGSHIP_BLOCKS, bn_mode=bn_mode), tree)
    opt = make_optimizer(model.parameters(), LR)
    step = make_train_step(model, TrainStepConfig(num_classes=13, spec=TINY_SPEC,
                                                  contrast=ContrastConfig()), opt, device="cpu")
    runs = []
    for seed in STEP_SEEDS[bn_mode]:
        batch = grid_clouds(2, FLAGSHIP_N, seed=seed)
        before = {"variables": to_jax_variables(model), "momentum": momentum_tree(model, opt)}
        parallel.reset_counts()
        with cbl_route("on"):
            metrics = step({k: mine(v) for k, v in batch.items()})
        runs.append({"batch": batch, "before": before, "counts": parallel.read_counts(),
                     "metrics": {k: host(v) for k, v in metrics.items()},
                     "after": to_jax_variables(model)})
    return runs


def voting_case():
    """run_voting_eval over a synthetic room (small widths, 2 crops of 2048
    points a request) → each cloud's accumulated probs."""
    from contrastboundary_tpu_torch.data import SyntheticSceneDataset
    from contrastboundary_tpu_torch.eval.run import run_voting_eval
    from contrastboundary_tpu_torch.models.init import init_like_flax

    model = init_like_flax(PointTransformerSeg(num_classes=13, planes=(16, 32, 64, 128, 256),
                                               blocks=(1,) * 5),
                           torch.Generator().manual_seed(3))
    ds = SyntheticSceneDataset(num_rooms=1, points_per_room=ROOM_POINTS, seed=0, split="val")
    ctx = {}
    m = run_voting_eval(model, PyramidSpec(), ds, n_points=2048, batch_size=2, num_votes=0.5,
                        device="cpu", ctx=ctx, log=lambda *_: None)
    return {"probs": [c.probs.copy() for c in ctx["evaluator"].clouds],
            "requests": ctx["evaluator"].requests, "mIoU": m["full"]["mIoU"]}


def main_case(out: Path, exp: str = "exp", val: bool = True):
    """main.py --mode train, then (with ``val``) --mode val, on the rooms
    of ``out/data`` into ``out/<exp>``: the models main.py built, their
    states after each, and the learning rate of each train step."""
    import contrastboundary_tpu_torch.main as entry

    built, lrs = [], []
    setup, set_lr = entry.setup, entry.set_learning_rate

    def recording_setup(*args, **kw):
        res = setup(*args, **kw)
        built.append(res[0])
        return res

    def recording_set_lr(optimizer, schedule, step):
        lrs.append(schedule(step))
        return set_lr(optimizer, schedule, step)

    sets = f"data.data_root:{out / 'data'};{MAIN_SETS}"
    argv = ["-c", "s3dis_pt_cbl", "--device", "cpu", "--set", sets, "--exp_dir", str(out / exp)]
    res = {}
    with mock.patch.object(entry, "setup", recording_setup), \
            mock.patch.object(entry, "set_learning_rate", recording_set_lr):
        res["best_miou"] = entry.main(argv + ["--mode", "train"])
        res["trained"] = {k: host(v) for k, v in built[-1].state_dict().items()}
        res["lrs"] = list(lrs)
        if val:
            res["val"] = entry.main(argv + ["--mode", "val", "--extra_ops", ""])
            res["restored"] = {k: host(v) for k, v in built[-1].state_dict().items()}
    return res


def run_all(trees) -> dict:
    """Every case but main.py's, the flagship's from ``trees``."""
    return {
        "bn": bn_cases(), "losses": loss_cases(), "conv": conv_case(),
        "flagship": {mode: flagship_steps(trees[mode], mode) for mode in ("batch", "stale")},
        "voting": voting_case(),
    }


if __name__ == "__main__":
    torch.set_num_threads(1)
    out = Path(sys.argv[1])
    info = parallel.maybe_initialize_distributed("cpu")
    with open(out / "trees.pkl", "rb") as f:
        trees = pickle.load(f)
    results = run_all(trees)
    results["main"] = main_case(out)
    try:
        parallel.local_rows({"x": np.zeros(3)})
    except ValueError as e:
        results["indivisible"] = str(e)
    results["info"] = {k: str(v) for k, v in info.items()}
    results["backend"] = torch.distributed.get_backend()
    with open(out / f"rank{info['process_index']}.pkl", "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()

"""CLI entry: config-driven training and evaluation of the port (counterpart
of contrastboundary_tpu/main.py, the same flags plus ``--device``):

  python -m contrastboundary_tpu_torch.main -c s3dis_pt_cbl --mode train \\
      --set data.data_root:/path/to/npy
  python -m contrastboundary_tpu_torch.main -c s3dis_pt_cbl --mode val \\
      --exp_dir <train run> --model_path auto
  python -m contrastboundary_tpu_torch.main -c scannet_pt_cbl --mode calibrate \\
      --set data.data_root:/path/to/npy
  python -m contrastboundary_tpu_torch.main -c scannet_pt_cbl --mode test \\
      --exp_dir <train run> --model_path best --out_dir <submission dir>

A named preset, a YAML update file and ``--set a.b:v;c:v`` overrides make
the config (config/); the model is built by ``Config.build_model``, its
fresh weights drawn from ``cfg.seed``; the train split's rooms are
augmented, cropped and padded (data/) by a prefetch thread; each step runs
the train step (train/trainer.py) under the config's schedule and
optimizer, with a NaN sentinel and scalars; each epoch ends with a voting
eval (eval/run.py) and a snapshot (train/checkpoint.py), which ``--mode
val`` restores. ``--mode test`` restores a snapshot, votes over the test
split and writes the predictions of every raw point (the Semantic3D and
NPM3D benchmarks' files, ``<scene>_pred.npy`` otherwise); ``--mode
calibrate`` measures the train rooms for the static crop size (and the
ConvNet's neighbour caps). Everything runs on ``--device`` (``cuda`` by
default: it raises without a card unless given ``--device cpu``), at world
size 1.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import load_config
from .data import (
    PotentialSampler, S3DISDataset, SyntheticSceneDataset, default_train_transform,
    make_batch_iterator,
)
from .data.calibrate import calibrate_crop_points, calibrate_neighborhood_limits
from .data.datasets import NPM3DDataset, ScanNetDataset, Semantic3DDataset, raw_projection
from .data.prefetch import prefetch
from .device import resolve_device
from .eval.metrics import AverageMeter, metrics_from_confusion
from .eval.run import analyze, run_enumerate_eval, run_voting_eval, zero_labels
from .eval.step import make_eval_step
from .eval.voting import VotingEvaluator
from .train import (
    CheckpointManager, TrainStepConfig, dump_nan_state, exponential_epoch_decay,
    find_best_snapshot, make_optimizer, make_train_step, multistep_epoch_decay,
    set_learning_rate,
)
from .utils import ScalarWriter, setup_logger, trace

TEST_SMOOTH = 0.98  # the probs' smoothing of the test split's vote rounds
DATASETS = {"scannet": ScanNetDataset, "semantic3d": Semantic3DDataset, "npm3d": NPM3DDataset}


def build_dataset(cfg, split: str):
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticSceneDataset(
            num_rooms=d.num_rooms, points_per_room=d.points_per_room, seed=cfg.seed,
            split=split, loop=d.loop if split == "train" else 1,
            ignore_fraction=d.ignore_fraction,
        )
    if d.dataset == "s3dis":
        return S3DISDataset(d.data_root, split=split, test_area=d.test_area,
                            loop=d.loop if split == "train" else 1)
    if d.dataset in DATASETS:
        return DATASETS[d.dataset](d.data_root, split=split,
                                   loop=d.loop if split == "train" else 1)
    raise ValueError(f"unknown dataset {d.dataset!r}")


def setup(cfg, logger, device):
    """→ (model, spec, step_cfg, optimizer, schedule, train_ds,
    steps_per_epoch). The model's fresh weights come from a generator seeded
    with ``cfg.seed``."""
    model = cfg.build_model(device=device, generator=torch.Generator().manual_seed(cfg.seed))
    spec = cfg.pyramid_spec()
    step_cfg = TrainStepConfig(num_classes=cfg.data.num_classes, spec=spec,
                               contrast=cfg.contrast, ignore_label=cfg.data.ignore_label)
    train_ds = build_dataset(cfg, "train")
    steps_per_epoch = max(len(train_ds) // cfg.optim.batch_size, 1)
    o = cfg.optim
    if o.schedule == "multistep":
        schedule = multistep_epoch_decay(
            o.base_lr, [m * o.epochs for m in o.milestones], o.multiplier, steps_per_epoch)
    else:
        schedule = exponential_epoch_decay(o.base_lr, o.decay_rate, steps_per_epoch)
    optimizer = make_optimizer(model.parameters(), schedule, optimizer=o.optimizer,
                               momentum=o.momentum, weight_decay=o.weight_decay,
                               grad_clip_norm=o.grad_clip_norm)
    nparams = sum(p.numel() for p in model.parameters())
    logger.info(f"model {cfg.model.arch} ({cfg.model.dtype}, {cfg.model.bn_mode} BN): "
                f"{nparams / 1e6:.2f}M params, {steps_per_epoch} steps/epoch on {device}")
    return model, spec, step_cfg, optimizer, schedule, train_ds, steps_per_epoch


def run_eval(cfg, model, spec, logger, device, num_votes=None, extra_ops: str = "",
             h5_path: str = "", ctx=None):
    """Voting evaluation over the val split. Pass a dict as ``ctx`` to keep
    the eval step, the val dataset and the evaluator across calls (each call
    a new vote round over the accumulated probs)."""
    ctx = ctx if ctx is not None else {}
    if "val_ds" not in ctx:
        ctx["val_ds"] = build_dataset(cfg, "val")
    return run_voting_eval(
        model, spec, ctx["val_ds"], num_classes=cfg.data.num_classes,
        n_points=cfg.data.n_points, batch_size=cfg.eval.batch_size,
        voxel_size=cfg.data.voxel_size,
        num_votes=num_votes if num_votes is not None else cfg.eval.num_votes,
        smooth=cfg.eval.smooth, seed=cfg.seed, crop_mode=cfg.data.crop_mode,
        in_radius=cfg.data.in_radius, base_radius=cfg.model.base_radius,
        extra_ops=extra_ops, h5_path=h5_path, device=device, ctx=ctx, log=logger.info)


def train(cfg, logger, exp_dir: str, device) -> float:
    """Train for ``cfg.optim.epochs`` epochs → the best full-cloud mIoU."""
    model, spec, step_cfg, optimizer, schedule, train_ds, steps_per_epoch = setup(
        cfg, logger, device)
    train_step = make_train_step(model, step_cfg, optimizer, device=device)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    transform = default_train_transform()
    scalars = ScalarWriter(exp_dir)
    best_miou = -1.0
    eval_ctx: dict = {}  # keeps the eval step, val dataset and evaluator across epochs
    step = 0  # updates applied, optax's count for the schedule

    pot_state = None
    if cfg.data.sampler == "potential":
        # persistent across epochs, so coverage potentials keep accumulating
        pot_state = PotentialSampler(train_ds, cfg.data.voxel_size, in_radius=cfg.data.in_radius,
                                     cap=cfg.data.voxel_max, seed=cfg.seed)
        logger.info(f"potential sampler over {len(pot_state.rooms)} rooms "
                    f"(in_radius {cfg.data.in_radius})")

    try:
        for epoch in range(cfg.optim.epochs):
            t0 = time.time()
            meters = {}
            conf_sum = None
            it = prefetch(
                lambda epoch=epoch: make_batch_iterator(
                    train_ds, cfg.optim.batch_size, cfg.data.n_points, seed=cfg.seed,
                    epoch=epoch, transform=transform, voxel_size=cfg.data.voxel_size,
                    voxel_max=cfg.data.voxel_max, crop_mode=cfg.data.crop_mode,
                    in_radius=cfg.data.in_radius, sampler=cfg.data.sampler,
                    potential_state=pot_state,
                ),
                depth=3,
            )
            n_steps = 0
            for i, batch in enumerate(it):
                batch.pop("src_idx"), batch.pop("room_idx")
                set_learning_rate(optimizer, schedule, step)
                if cfg.runtime_freq and (i + 1) % cfg.runtime_freq == 0:
                    with trace(os.path.join(exp_dir, "traces")):
                        metrics = train_step(batch)
                else:
                    metrics = train_step(batch)
                step += 1
                n_steps += 1
                # NaN sentinel, at log_freq (the float() is paid for logging
                # anyway) or every step under debug_nan: a diverged run halts
                # with a reproducer
                if (cfg.debug_nan or (i + 1) % cfg.log_freq == 0) and not np.isfinite(
                        float(metrics["loss"])):
                    dump_nan_state(exp_dir, model, step, batch, metrics, logger)
                    raise FloatingPointError(f"NaN loss at step {step}")
                conf = metrics.pop("confusion")
                conf_sum = conf if conf_sum is None else conf_sum + conf
                if (i + 1) % cfg.log_freq == 0:
                    for k, v in metrics.items():
                        meters.setdefault(k, AverageMeter()).update(float(v))
                    scalars.write(step, {f"train/{k}": float(v) for k, v in metrics.items()})
                    logger.info(
                        f"epoch {epoch} step {i + 1}/{steps_per_epoch}: "
                        + " ".join(f"{k}={m.avg:.4f}" for k, m in sorted(meters.items())
                                   if not k.startswith("cbl_stage")))
            tm = metrics_from_confusion(conf_sum.cpu().numpy())
            dt = time.time() - t0
            pps = n_steps * cfg.optim.batch_size * cfg.data.n_points / max(dt, 1e-9)
            logger.info(f"epoch {epoch} done in {dt:.1f}s ({pps / 1e3:.0f}k pts/s): "
                        f"train mIoU {tm['mIoU']:.4f} OA {tm['OA']:.4f}")
            scalars.write(step, {"epoch": epoch, "epoch/train_mIoU": tm["mIoU"],
                                 "epoch/train_OA": tm["OA"], "epoch/points_per_sec": pps})

            if (epoch + 1) % cfg.eval.eval_freq == 0 or epoch == cfg.optim.epochs - 1:
                m = run_eval(cfg, model, spec, logger, device, ctx=eval_ctx)
                miou = m["full"]["mIoU"]
                is_best = miou > best_miou
                best_miou = max(best_miou, miou)
                scalars.write(step, {"epoch": epoch, "val/mIoU": miou,
                                     "val/best_mIoU": best_miou})
                if (epoch + 1) % cfg.save_freq == 0 or is_best:
                    ckpt.save(step, model, optimizer, best=is_best, metric=miou)
                    logger.info(f"saved snap-{step}" + (" (best)" if is_best else ""))
    finally:
        scalars.close()
    logger.info(f"training done; best full-cloud mIoU {best_miou:.4f}")
    return best_miou


def _resolve_model_path(exp_dir: str, model_path: str, logger) -> str:
    """'best' resolves across the experiment dir's ``Log_*`` runs, not just
    within this run's checkpoints/."""
    if model_path != "best":
        return model_path
    hit = find_best_snapshot(exp_dir)
    if hit is None:
        return model_path  # fall through to within-run resolution
    miou = "" if hit["mIoU"] == float("-inf") else f" (mIoU {hit['mIoU']:.4f})"
    logger.info(f"best across runs: step {hit['step']}{miou} from {hit['run']}")
    return hit["path"]


def validate(cfg, logger, exp_dir: str, model_path: str, device, extra_ops: str = "",
             protocol: str = "voting") -> dict:
    """Restore a snapshot of ``exp_dir`` (auto | best | path) and evaluate it
    by the voting or the enumeration protocol."""
    model, spec, _, optimizer, _, _, _ = setup(cfg, logger, device)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    model_path = _resolve_model_path(exp_dir, model_path, logger)
    step, skipped = ckpt.restore(model, optimizer, model_path)
    if skipped:
        logger.info(f"partial restore skipped {len(skipped)} leaves")
    logger.info(f"restored step {step}")
    if protocol == "enumerate":
        d = cfg.data
        return run_enumerate_eval(
            model, spec, build_dataset(cfg, "val"), num_classes=d.num_classes,
            n_points=d.n_points, voxel_size=d.voxel_size, voxel_max=d.voxel_max,
            batch_size=cfg.eval.batch_size, seed=cfg.seed, base_radius=cfg.model.base_radius,
            extra_ops=extra_ops, device=device, log=logger.info)
    h5 = os.path.join(exp_dir, f"val_{step}.h5") if "save" in extra_ops else ""
    return run_eval(cfg, model, spec, logger, device, extra_ops=extra_ops, h5_path=h5)


def run_test(cfg, logger, exp_dir: str, model_path: str, device, out_dir: str = "") -> str:
    """Restore a snapshot of ``exp_dir`` (auto | best | path), vote over the
    test split (no labels, smoothing TEST_SMOOTH), take the argmax on each
    voted sub-cloud, carry it to the room's points (``ev.proj``) and to the
    raw scan's (the dataset's raw projection, where it has one), and write
    the benchmark's files → the zip (Semantic3D) or the output directory."""
    model, spec, _, optimizer, _, _, _ = setup(cfg, logger, device)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    model_path = _resolve_model_path(exp_dir, model_path, logger)
    step, skipped = ckpt.restore(model, optimizer, model_path)
    logger.info(f"restored step {step} (skipped {len(skipped)})")

    test_ds = build_dataset(cfg, "test")
    eval_step = make_eval_step(model, spec, device, num_classes=cfg.data.num_classes)

    def predict(batch):
        return eval_step(zero_labels(batch))[0].cpu().numpy()

    d = cfg.data
    ev = VotingEvaluator(test_ds, predict, d.num_classes, d.n_points,
                         batch_size=cfg.eval.batch_size, voxel_size=d.voxel_size,
                         num_votes=cfg.eval.num_votes, smooth=TEST_SMOOTH, seed=cfg.seed,
                         crop_mode=d.crop_mode, in_radius=d.in_radius)
    ev.run(progress=lambda s, p: logger.info(f"  test vote step {s}, min_pot {p:.2f}"))

    predictions = {}
    for r, name in enumerate(test_ds.names):
        pred = ev.clouds[r].predictions()[ev.proj[r]]  # voted sub-cloud → the room's points
        proj = raw_projection(test_ds, name)
        if proj is None:
            logger.info(f"{name}: no raw projection file — submitting npy-level")
        else:
            pred = pred[proj]
        predictions[name] = pred
        logger.info(f"{name}: {len(pred)} point predictions")

    out_dir = out_dir or os.path.join(exp_dir, "submission")
    if d.dataset == "semantic3d":
        zpath = Semantic3DDataset.write_submission(out_dir, predictions)
        logger.info(f"submission zip: {zpath}")
        return zpath
    if d.dataset == "npm3d":
        files = NPM3DDataset.write_submission(out_dir, predictions)
        logger.info(f"submission files: {len(files)} in {out_dir}")
        return out_dir
    os.makedirs(out_dir, exist_ok=True)  # no external benchmark: the predictions as npy
    for name, pred in predictions.items():
        np.save(os.path.join(out_dir, f"{name}_pred.npy"), pred)
    logger.info(f"saved raw predictions to {out_dir}")
    return out_dir


def calibrate(cfg, logger, max_clouds: int = 10) -> int:
    """Measure up to ``max_clouds`` train rooms and log the static caps to
    put in the config (data/calibrate.py) → the crop size ``n_points``. The
    neighbour caps (ConvNet) need only the config's strides, radius and
    voxel size, no model."""
    ds = build_dataset(cfg, "train")
    clouds = [ds.room(i)[0] for i in range(min(ds.num_rooms, max_clouds))]
    n_points = calibrate_crop_points(clouds, cfg.data.in_radius, cfg.data.voxel_size,
                                     max_clouds=max_clouds)
    logger.info(f"calibrated crop size (radius {cfg.data.in_radius} m, 90th pct, pow2): "
                f"data.n_points={n_points}")
    if cfg.model.arch == "convnet":
        nl = len(cfg.model.strides)
        radii = [cfg.model.base_radius * 2 ** i for i in range(nl)]
        cells = [cfg.data.voxel_size * 2 ** i for i in range(nl)]
        limits = calibrate_neighborhood_limits(clouds, radii, cells, max_clouds=max_clouds)
        logger.info(f"calibrated neighbor caps (80% untouched criterion): "
                    f"model.neighborhood_limits={limits}")
    return n_points


def check_pipeline(cfg, logger, num_batches: int = 8):
    """Input-pipeline check: runs the batch iterator alone and reports its
    time a batch and the label, duplicate-pad and extent histograms."""
    ds = build_dataset(cfg, "train")
    it = make_batch_iterator(
        ds, cfg.optim.batch_size, cfg.data.n_points, seed=cfg.seed,
        transform=default_train_transform(), voxel_size=cfg.data.voxel_size,
        voxel_max=cfg.data.voxel_max,
    )
    t0 = time.time()
    label_counts = np.zeros(cfg.data.num_classes + 1, np.int64)
    dup_fracs, extents = [], []
    n = 0
    for i, batch in enumerate(it):
        if i >= num_batches:
            break
        n += 1
        lab = batch["labels"]
        np.add.at(label_counts, np.where(lab >= 0, lab, cfg.data.num_classes).ravel(), 1)
        for b in range(lab.shape[0]):
            src = batch["src_idx"][b]
            dup_fracs.append(1 - len(np.unique(src)) / len(src))
            extents.append(batch["points"][b].max(0) - batch["points"][b].min(0))
    dt = (time.time() - t0) / max(n, 1)
    logger.info(f"pipeline: {dt * 1000:.0f} ms/batch (B={cfg.optim.batch_size}, "
                f"N={cfg.data.n_points})")
    logger.info(f"duplicate-pad fraction: mean {np.mean(dup_fracs):.3f} "
                f"max {np.max(dup_fracs):.3f}")
    ex = np.stack(extents)
    logger.info(f"crop extent (m): mean {ex.mean(0).round(2)} max {ex.max(0).round(2)}")
    total = label_counts.sum()
    hist = " ".join(f"{c}:{100 * v / total:.1f}%" for c, v in enumerate(label_counts[:-1]))
    logger.info(f"label histogram: {hist} ignored:{100 * label_counts[-1] / total:.1f}%")


def main(argv=None):
    parser = argparse.ArgumentParser(description="contrastboundary_tpu_torch")
    parser.add_argument("-c", "--config", default="synthetic_tiny")
    parser.add_argument("--mode", default="train",
                        choices=["train", "val", "test", "check", "calibrate", "analyze"])
    parser.add_argument("--h5", default="", help="analyze mode: saved val_*.h5 eval artifacts")
    parser.add_argument("--set", dest="sets", default=None, help="overrides a.b:v;c.d:v")
    parser.add_argument("--cfg_file", default=None,
                        help="YAML update file merged over the -c preset; -c may also be a "
                             ".yaml path directly")
    parser.add_argument("--model_path", default="auto", help="val mode: auto | best | <path>")
    parser.add_argument("--extra_ops", default="boundary-stat",
                        help="val mode extras: boundary | stat | feature (per-stage latent "
                             "boundary distances) | save (h5)")
    parser.add_argument("--exp_dir", default=None)
    parser.add_argument("--out_dir", default="", help="test mode: submission output directory")
    parser.add_argument("--protocol", default="voting", choices=["voting", "enumerate"],
                        help="val protocol: voting or the whole-scene voxel-duplicate "
                             "enumeration")
    parser.add_argument("--device", default="cuda",
                        help="torch device; without a card pass 'cpu'")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config, args.sets, cfg_file=args.cfg_file)
    exp_dir = args.exp_dir or os.path.join(
        cfg.save_path, cfg.data.dataset, cfg.name, time.strftime("Log_%m%d_%H%M%S"))
    if args.mode in ("val", "test") and args.exp_dir is None:
        raise SystemExit(f"--mode {args.mode} requires --exp_dir pointing at a train run")
    os.makedirs(exp_dir, exist_ok=True)
    logger = setup_logger(log_file=os.path.join(exp_dir, f"log_{args.mode}.txt"))
    logger.info(f"config {cfg.name}: heads={list(cfg.heads)} exp_dir={exp_dir}")

    np.random.seed(cfg.seed)
    if args.mode == "train":
        return train(cfg, logger, exp_dir, device)
    if args.mode == "check":
        return check_pipeline(cfg, logger)
    if args.mode == "calibrate":
        return calibrate(cfg, logger)
    if args.mode == "test":
        return run_test(cfg, logger, exp_dir, args.model_path, device, args.out_dir)
    if args.mode == "analyze":
        return analyze(args.h5, cfg.data.num_classes, cfg.model.base_radius,
                       args.extra_ops, log=logger.info)
    return validate(cfg, logger, exp_dir, args.model_path, device, args.extra_ops,
                    protocol=args.protocol)


if __name__ == "__main__":
    main()

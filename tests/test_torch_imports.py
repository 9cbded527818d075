"""The port stands alone: it and chip_smoke.py import no JAX and nothing of
the JAX package, and its entry points refuse to run without CUDA unless
asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "contrastboundary_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "contrastboundary_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_and_chip_smoke_import_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"for m in {mods!r} + ['chip_smoke']:\n    importlib.import_module(m)\n"
        + "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from contrastboundary_tpu_torch.eval.step import make_eval_step
    from contrastboundary_tpu_torch.models import PointTransformerSeg
    from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PointTransformerSeg(planes=(16,) * 5, blocks=(1,) * 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(model, PyramidSpec())
    step = make_eval_step(model, PyramidSpec(), device="cpu")
    rng = np.random.RandomState(0)
    probs, conf = step({
        "points": rng.rand(1, 512, 3).astype(np.float32),
        "features": rng.rand(1, 512, 3).astype(np.float32),
        "labels": np.zeros((1, 512), np.int32),
    })
    assert probs.shape == (1, 512, 13) and float(conf.sum()) == 512


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    from contrastboundary_tpu_torch.ops.cuda import tile_gather, win_topk

    pts = torch.rand(1, 64, 3)
    before = (win_topk.launches, tile_gather.launches)
    win_topk.window_topk(pts, pts, 4, tile=16, width=3, window=1)
    tile_gather.window_gather(torch.rand(1, 64, 8), torch.zeros(1, 64, 2, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), 16, 3)
    assert (win_topk.launches, tile_gather.launches) == before  # plain: no launch
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError):
        win_topk.window_topk(meta, meta, 4, tile=16, width=3, window=1)


def test_train_kernel_wrappers_take_the_plain_version_only_on_cpu():
    from contrastboundary_tpu_torch.ops.cuda import cbl_dense, tile_gather

    counts = lambda: (tile_gather.bwd_launches, cbl_dense.fwd_launches, cbl_dense.bwd_launches)
    before = counts()
    li = torch.zeros(1, 64, 2, dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int32)
    tile_gather.window_gather_bwd(torch.rand(1, 64, 2, 8), li, starts, 16, 3, 64)
    feats, meta = torch.rand(1, 64, 32), torch.zeros(1, 64, 8)
    stats = cbl_dense.cbl_stats_fwd(feats, meta, li, 1.0, 16, 3, 1)
    cbl_dense.cbl_stats_bwd(feats, meta, li, stats, torch.rand(1, 64, 8), 1.0, 16, 3, 1)
    assert counts() == before  # plain: no launch
    on_meta = lambda *shape: torch.empty(*shape, device="meta")
    with pytest.raises(ValueError):
        tile_gather.window_gather_bwd(on_meta(1, 64, 2, 8), li, starts, 16, 3, 64)
    with pytest.raises(ValueError):
        cbl_dense.cbl_stats_fwd(on_meta(1, 64, 32), meta, li, 1.0, 16, 3, 1)
    with pytest.raises(ValueError):
        cbl_dense.cbl_stats_bwd(on_meta(1, 64, 32), meta, li, stats, torch.rand(1, 64, 8), 1.0,
                                16, 3, 1)


def test_train_entry_point_needs_cuda_unless_cpu(monkeypatch):
    from contrastboundary_tpu_torch.models import PointTransformerSeg
    from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec
    from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PointTransformerSeg(planes=(16,) * 5, blocks=(1,) * 5)
    cfg = TrainStepConfig(num_classes=13, spec=PyramidSpec(k_contrast=(36, 24, 24, 24, 24), with_subscene=True))
    opt = make_optimizer(model.parameters(), 0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, cfg, opt)
    metrics = make_train_step(model, cfg, opt, device="cpu")({
        "points": np.random.RandomState(0).rand(1, 512, 3).astype(np.float32),
        "features": np.random.RandomState(1).rand(1, 512, 3).astype(np.float32),
        "labels": np.zeros((1, 512), np.int32),
    })
    assert np.isfinite(float(metrics["loss"])) and float(metrics["confusion"].sum()) == 512


def test_runtime_modules_are_among_the_checked_files():
    """The checks above walk every file of the port: the entry point, its
    config, data (the preparers and datasets among them), native, train and
    utils modules."""
    names = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in _port_files()}
    expected = {f"contrastboundary_tpu_torch.{m}" for m in (
        "main", "config.base", "config.dsl", "config.s3dis", "data.pipeline", "data.prefetch",
        "data.s3dis", "data.transforms", "models.init", "train.checkpoint", "train.debug",
        "train.schedule", "train.state", "utils.logger", "utils.profiling", "utils.scalars",
        "data.calibrate", "data.datasets", "data.ingest", "data.prepare",
        "data.prepare_scannet", "data.synthetic", "native", "utils.mesh", "utils.ply",
        "utils.storage")}
    assert expected <= names, sorted(expected - names)


def test_convnet_modules_are_checked_and_its_steps_need_cuda_unless_cpu(monkeypatch):
    """The ConvNet family's modules are among the files walked above, and
    its train and eval steps raise without CUDA unless given the CPU."""
    from contrastboundary_tpu_torch.config import load_config
    from contrastboundary_tpu_torch.eval.step import make_eval_step
    from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step

    names = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in _port_files()}
    expected = {f"contrastboundary_tpu_torch.{m}" for m in (
        "ops.voxel", "ops.sampling", "ops.knn", "ops.pyramid", "core.masking",
        "models.local_aggregation", "models.convnet", "losses.contrast")}
    assert expected <= names, sorted(expected - names)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("synthetic_conv_tiny", "model.base_fdim:12;model.strides:[1,4,4]")
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.build_model()
    model = cfg.build_model(device="cpu")
    spec = cfg.pyramid_spec()
    opt = make_optimizer(model.parameters(), 0.05)
    step_cfg = TrainStepConfig(num_classes=13, spec=spec, contrast=cfg.contrast)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, step_cfg, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(model, spec)
    rng = np.random.RandomState(0)
    batch = {"points": np.round(rng.rand(1, 512, 3) * 64).astype(np.float32) / 64,
             "features": rng.rand(1, 512, 3).astype(np.float32),
             "labels": rng.randint(0, 13, (1, 512)).astype(np.int32)}
    metrics = make_train_step(model, step_cfg, opt, device="cpu")(batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["confusion"].sum()) == 512
    probs, _ = make_eval_step(model, spec, device="cpu")(batch)
    assert probs.shape == (1, 512, 13) and bool(torch.isfinite(probs).all())


def test_parallel_modules_are_checked_and_need_no_group_alone():
    """The data-parallel modules (parallel/) are among the files walked
    above; without a process group the port's world size is 1 (a step's
    collectives at world size 1 are counted in tests/test_torch_parallel.py)."""
    from contrastboundary_tpu_torch import parallel

    names = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in _port_files()}
    expected = {f"contrastboundary_tpu_torch.{m}" for m in (
        "parallel.__init__", "parallel.distributed", "parallel.mesh")}
    assert expected <= names, sorted(expected - names)
    assert not torch.distributed.is_initialized()
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card, nvcc and the
trained checkpoint results/ckpts/parity_s0_fast_e15.pkl. Phases, each
printed with its elapsed seconds; any failed check raises, so the exit code
is not 0:

1. build   the CUDA kernels (one nvcc -c a source, all started together, then
           one link, into contrastboundary_tpu_torch/_build/<hash>/).
2. kernels window top-k and window gather against their plain PyTorch
           versions on the card, at every geometry of a B=2 x N=65536
           request: integer-grid clouds with duplicated rows (exact) and
           synthetic crops (values 1e-5, index disagreement <= 1e-4 of
           slots, which allows for near-ties); window top-k where no
           path takes it (k > W in the self and cross geometries,
           exclude_self), exact on the integer grid; and window gather
           directly at C in {1, 2, 3, 5, 35, 67, 131, 259, 1024} in the self
           and cross geometries, and from a misaligned x (the scalar-read
           path at C % 4 == 0), equal to the plain version.
3. serve   the trained flagship (full width, float32) on B=2 x N=65536
           crops of synthetic val room 0: one request with the launch counts
           reset just before and read just after (both must be > 0) and the
           running statistics untouched, three timed requests, and one with
           both kernels swapped for their plain versions (probs within 1e-3,
           argmax agreeing on >= 99.9% of points); crop overall accuracy
           must be >= 0.5.
4. timing  every kernel launch of that request replayed: kernel, plain
           version and one PyTorch library call, each with L2 flushed, beside
           its bound (bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s,
           the H100 SXM data sheet, whichever is larger); the largest
           window_topk call also 20 times through its wrapper and through
           its bare C entry.
5. profile the request split: pyramid alone and whole step (CUDA events),
           and one torch.profiler trace: device time by kernel and the
           device's busy share of the request.
6. voting  VotingEvaluator over room 0 for three requests.
7. stale-serve the same checkpoint in a bn_mode='stale' model, whose 18
           attention layers run the fused attention kernel: one request with
           the counts reset (pt_attn_fwd exactly 18), the running statistics
           untouched, three timed requests beside phase serve's median,
           probs against the plain versions' and against phase serve's
           batch-BN probs (eval-mode BN is the same function: 1e-3, argmax
           >= 99.9%), crop OA >= 0.5, three voting requests; each
           pt_attn_fwd launch against its plain version (1e-4 of scale, the
           same bits of out, s1 and s2 when run again), timed, and the times
           summed per width (C, M, K, launches, ms, bound).
8. train   the flagship train step (train/trainer.py::make_train_step: the
           training pyramid, the model in train mode, CE + 5-stage CBL,
           backward, SGD lr 0.05) from the checkpoint on B=2 x N=65536 crops
           of synthetic train rooms: one step with every launch count reset
           just before and read just after (all five kernels must be > 0; the
           searches wider than 2048 rows, plain PyTorch by the reference's
           width rule, are counted apart); one step with the kernels and one
           with the plain versions from the same weights and batch (loss rel
           <= 1e-4, global gradient norm rel <= 1e-3, running statistics rel
           <= 1e-4); five steps on that batch (every loss finite, the last
           below the first), the median of the three warm ones on the host
           clock, points/s and max_memory_allocated; one step under
           torch.profiler.
9. train-kernels every kernel call of that step against its plain version:
           window_topk and window_gather as in phase 2, window_gather_bwd
           max-abs <= 1e-5 of the output's scale (the plain version's
           index_add_ adds with atomics on the card), exact on integer
           cotangents, the same bits when run again, and bit-equal to the
           plain version on CPU copies (CPU index_add_ sums each row in slot
           order, as the kernel does), cbl_stats_fwd counts exact, sums rel
           <= 1e-5 and the same bits on every lane when run again,
           cbl_stats_bwd max-abs <= 1e-4 of the output's
           scale, the same bits when run again, and its first pass's slot
           coefficients cd within 1e-5 of their scale of the plain
           version's; the same on one step over integer-grid clouds. Then
           each call timed as in phase 4 (5 runs each), and the largest
           (level-0) window_topk, window_gather, window_gather_bwd,
           cbl_stats_fwd and cbl_stats_bwd calls 20 times through the wrapper
           and through the bare C entry.
10. stale-train phase 8 with bn_mode='stale': pt_attn_fwd and pt_attn_bwd
           exactly 18 launches each, window_gather and window_gather_bwd 18
           fewer than in phase 8 (the attention layers' gathers are inside
           the kernel), the same kernel-vs-plain, five-step, timing, memory
           and profile checks.
11. stale-kernels every pt_attn call of that step against its plain version
           (out, both statistic pairs, dq, dkv and each of the 12 parameter
           gradients within 1e-4 of scale; the forward's out, s1 and s2 the
           same bits when run again), and of one stale step on integer-grid
           clouds, whose backward calls also give dkv exactly on integer
           cotangents (with W4 = 0, so that the softmax weights are exact);
           then each call timed as in phase 4 (5 runs each), both kernels'
           times summed per width (C, M, K, launches, ms, bound), and the
           largest (level-0) call of each 20 times through the wrapper and
           through the bare C entry.

12. cbl-xla the flagship train step of phase 8 with CBL_DENSE=off and
           ContrastConfig(impl='xla'), the reference's XLA tile route: the
           label pack and the latents gathered by window_gather (its backward
           by window_gather_bwd), exactly 5 more launches of each than phase
           8 (one a stage) and none of a CBL kernel; kernel vs plain step,
           five steps, step time, memory and profile as in phase 8.
13. cbl-pallas the same with impl='pallas', the fused v2 kernel:
           cbl_tile2_fwd and cbl_tile2_bwd exactly 5 launches each (the
           backward reads the forward's statistics), the dense CBL kernels
           none, the gathers as in phase 8; the same step checks; and the CBL
           losses of one step of phases 8 and 13 against phase 12's on the
           same weights and batch, each stage within the tolerance the CPU
           tests state (dense 3e-5, v2 1e-5).
14. cbl-kernels every v2 call of phase 13's step against its plain version
           and timed: the forward's counts and mask exact on every row,
           lanes 0-2 and loss·mask within 1e-4 of scale on the rows of the
           mask and the fill (0, 0, 0; loss·mask 0) elsewhere, the same bits
           when run again; the backward within 1e-4 of scale, the same bits
           when run again, its pass-1 coefficients within 1e-5 of scale; the
           level-0 calls also 20 times alone for the spread of a launch's
           time, with the backward scatter's terms a support tile; v1
           (cbl_tile_fwd, cbl_tile_bwd), which no path runs,
           at that step's level-0 shape ([soft labels | latents], K = 35)
           against its plain version as v2 is held (the backward's label
           columns zero and its feature columns v2's backward bit for bit
           on v1's split with v1's statistics) and against v2 on the same
           inputs, its level-0 calls also 20 times alone;
           gather_rows, which no path runs either, equal to x[idx] at x
           [131072, 128] f32 with 131072 random rows, timed beside
           torch.index_select.
15. plan-shapes direct calls at shapes the reference trains beyond the
           flagship's, whose plans take smaller tiles or slot chunks, on
           seeded inputs: pt_attn_fwd and pt_attn_bwd at C = 512 with K = 8
           (M = 1024) and K = 32 and 48 (M = 256), held as in phase 11; and
           cbl_stats_fwd on windows wider than shared memory holds (width 7
           x tile 256 and width 3 x tile 1024, K = 36), read through L2 and
           held as in phase 9, with the L2 path at the flagship's level-0
           window equal bit for bit to the staged path; and cbl_tile2_fwd and
           cbl_tile2_bwd at every shape class the previous v2 kernels took
           (V2_SHAPES: C in {1, 20, 32, 33, 64, 128}, K in {1, 35, 300},
           M·K >= 2^23, tile x width 128 x 5 and 1024 x 1, every row and no
           row in the loss mask) held as in phase 14; and v1 at V1_SHAPES
           (C in {1, 32, 33, 128}, ncls in {1, 13, 40} with ties among the
           label columns, K in {1, 35}) held as in phase 14.
16. bf16-serve the checkpoint in PointTransformerSeg(dtype=bfloat16), batch
           BN, on phase serve's crops: one request with the counts reset
           (window_gather launched on bfloat16 rows), the running statistics
           untouched, probs against the plain versions' within half of the
           bf16-vs-f32 probs gap from the same weights (phase serve's probs;
           printed as the scale beside it), argmax agreement >= 99.5%, crop
           OA >= 0.5, the median of 3 warm requests and the peak memory
           beside phase serve's, one voting request.
17. bf16-train phase 8 with the bf16 model: the launches by dtype (window_gather
           18 bfloat16 and 21 float32, window_gather_bwd 18 bfloat16 and 12
           float32: the attention layers' kv rows are bfloat16, the other
           gathers' inputs come out of a BN), kernel vs plain step (loss rel
           <= 1e-3, gradient norm rel <= 1e-2, running statistics rel <=
           1e-2) with the bf16-vs-f32 step gap from the same weights (phase
           8's step) printed beside them, five steps that lower the loss, the
           step median, peak memory and busy share beside phase 8's and
           PERF.md's f32 numbers.
18. bf16-stale phases 7 and 10 with the bf16 model under bn_mode='stale': a
           request (pt_attn_fwd 18 bfloat16 launches, the same probs, OA and
           timing checks as phase 16 against phase serve's probs, one voting
           request) and the train step (pt_attn_fwd and pt_attn_bwd 18
           bfloat16 launches each, the checks of phase 17 against phase 10's
           step).
19. bf16-kernels the four bfloat16 kernel instances on the recorded calls of
           phases 17 (the gathers) and 18 (the attention) against their plain
           versions: window_gather bit for bit; window_gather_bwd within one
           bfloat16 ulp of the plain version's float32 sum, exact on integer
           cotangents, the same bits when run again and the plain version's
           CPU sum rounded once bit for bit; pt_attn_fwd and pt_attn_bwd out,
           dq and dkv within one bfloat16 ulp plus 1e-4 of scale, the
           statistics and the 12 gradients within 1e-4 of scale, the forward
           the same bits twice; each timed as in phase 4, with the bound from
           the bfloat16 bytes and the library calls x[b, rows] and a float32
           index_add_ of g.float() then .to(bfloat16); and each call beside
           its float32 twin (the operands widened) in turns, summed.
20. eval-features the checkpoint through make_eval_step(output='logits',
           with_features=True) on phase serve's crops: one request with the
           counts reset (window_topk and window_gather launched as in phase
           serve), softmax(logits) within 1e-6 of phase serve's probs with the
           same argmax, each stage's latent [B, N, d] finite in the caller's
           row order, the logits and every latent within 1e-3 of their scale
           of the plain versions'; the same for one stale-BN request against
           phase stale-serve (pt_attn_fwd exactly 18).
21. voting-features run_voting_eval over synthetic val room 0 (71,303 points
           after voxelization) with the feature step, num_votes 1.0, at most
           40 requests (requests, final minimum potential, sub and full mIoU
           and OA), then run_boundary_suite with 'boundary-stat-feature' on
           the voted cloud: B-IoU finite in [0, 1], every latent's l2, cos and
           norml2 distances finite, pct_err_on_bound_label printed.
22. enumerate run_enumerate_eval over room 0 (n_points 65536, voxel_max
           80000, B=2 crops a request, 'boundary-stat'): every point covered,
           full OA >= 0.5 with the trained checkpoint; passes, parts,
           requests, the eval step's median ms a request on the host clock,
           the room's seconds split into the eval step (to a synchronize) and
           the host's numpy and copies, B-IoU. Phases 20-26 print the card's
           name and power limit.
23. bf16-eval-features phase 20 with the checkpoint in the bfloat16 model,
           under batch and stale BN, on phase serve's crops: the launches and
           the launches by dtype those of phase bf16-serve's and bf16-stale's
           requests, softmax(logits) equal to their probs (max |d| 0) with the
           same argmax, every latent finite, and the RMS of its difference
           from the plain versions' at most half the RMS of its
           bfloat16-vs-float32 gap (phase 20's latents, the same weights) or
           twice the RMS by which the plain version's latents move when the
           fused attention sums its slots in reverse order (sum order alone).
24. train-entry the flagship trained through the port's entry point,
           main.py's main(["-c", "s3dis_pt_cbl", "--mode", "train", ...]):
           4 synthetic train rooms (Area_1) and 1 val room (Area_5) of
           120,000 points written as S3DIS xyzrgbl .npy files in a temporary
           directory; full width and depth from the flax-like init,
           default_train_transform, prefetch depth 3; cut to batch 2 (from
           16), 1 epoch (from 200) and loop 2 (from 30): 4 steps, then the
           epoch-end voting eval (num_votes 1.0, 4 crops a request) and the
           snapshot; log_freq 1 reads every step's loss. The phase wraps
           main.py's prefetch (StepProbe: utils/profiling.py::StepTimer, the
           wait for each batch, each step ended by a synchronize, the
           launches each step made): every loss finite (read back with
           read_scalars), each step's launches equal to phase 8's, every
           kernel of the path launched in the run, snap-4 and best.json
           written; the wait, step median, points/s and peak memory; the
           same run with the iterator in the loop's thread (no eval
           request); then main(["--mode", "val", "--model_path", "auto"])
           on the run: the restored parameters, buffers and momentum equal
           the live model's bit for bit, and its probs on phase serve's
           batch within 1e-6 of the live model's.
25. train-entry-bf16 two steps of s3dis_pt_cbl_bf16 through main.py (no
           eval request: num_votes 0): losses finite, each step's gathers
           by dtype 18 bfloat16 + 21 float32 and backward 18 + 12 (phase
           17's).
26. prepare-test ScanNet's offline path through main.py: three raw scenes
           (data/synthetic.py::write_scannet_scene: 6 x 6 x 3 m rooms, a
           floor, four walls and six boxes as binary ply meshes with faces,
           raw label ids of the benchmark, one box and 2% of the vertices
           with ignored ids) converted by prepare_scannet (rasterized at
           2000 points/m^2: ~250,000 points a scene); --mode calibrate
           (data.n_points logged); --mode train on scannet_pt_cbl at full
           width (20 classes, N = 65536, voxel_max 80000; the sorted layout
           and strided sampler; batch 2, loop 2: 3 steps, no eval request),
           each step's launches equal to phase 8's, losses finite; --mode
           test --model_path auto on the same scenes with the preset's 2.0
           votes: each request's launches equal to phase serve's, the first
           request's probs against the plain versions' on the same weights
           (1e-3, argmax >= 99.9%), and each scene's <scene>_pred.npy one
           class in 0-19 for each prepared point.

It prints the card's name and power limit, one JSON line of per-kernel
numbers (times are sums over the launches of one run of a path: the numbers
of the kernels a request runs, window_topk, window_gather and pt_attn_fwd,
are per serving request, with those of one train step under "train"; the
training kernels' numbers are per train step; v1 and gather_rows, which
no path runs, have the launches read from phase 13's step, which must be
0 as in every train run, and their direct calls under "direct_launches"),
and the bfloat16 instances as entries of their own, per train step (the
gathers of phase 17's step, the attention of phase 18's), and as its last
line {"ok": true, "device": {...}}. Without CUDA it exits with 2 before
doing anything.
"""
from __future__ import annotations

import copy
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from contrastboundary_tpu_torch import main as entry
from contrastboundary_tpu_torch.data.prepare_scannet import prepare_scannet
from contrastboundary_tpu_torch.data.synthetic import (
    SyntheticSceneDataset, train_batch, write_scannet_scene,
)
from contrastboundary_tpu_torch.eval.run import (
    run_boundary_suite, run_enumerate_eval, run_voting_eval,
)
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
from contrastboundary_tpu_torch.kernels import build
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_checkpoint, load_jax_variables,
)
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.losses import contrast as cbl_losses
from contrastboundary_tpu_torch.ops import PyramidSpec, build_pyramid, knn
from contrastboundary_tpu_torch.ops.cuda import cbl_dense as cd
from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda import gather_dma as gd
from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
from contrastboundary_tpu_torch.ops.tile_gather import window_starts
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from contrastboundary_tpu_torch.utils import StepTimer, read_scalars

# main.py's own prefetch, setup and eval step, which phases 24-26 wrap
entry_prefetch, entry_setup, entry_eval_step = entry.prefetch, entry.setup, entry.make_eval_step
ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "results" / "ckpts" / "parity_s0_fast_e15.pkl"
B, N, NUM_CLASSES = 2, 65536, 13
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, CUDA cores, no tensor cores
KERNELS = {
    "window_topk": dict(
        source="contrastboundary_tpu_torch/csrc/win_topk.cu",
        replaces="contrastboundary_tpu/ops/pallas/win_topk.py:157",
    ),
    "window_gather": dict(
        source="contrastboundary_tpu_torch/csrc/tile_gather.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:120",
    ),
    "window_gather_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/window_gather_bwd.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:156",
    ),
    "cbl_stats_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:247",
    ),
    "cbl_stats_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:272",
    ),
    "pt_attn_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:406",
    ),
    "pt_attn_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:830",
    ),
    "cbl_tile2_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:317",
    ),
    "cbl_tile2_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:350",
    ),
    "cbl_tile_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:233",
    ),
    "cbl_tile_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:259",
    ),
    "gather_rows": dict(
        source="contrastboundary_tpu_torch/csrc/gather_rows.cu",
        replaces="contrastboundary_tpu/ops/pallas/gather_dma.py:52",
    ),
    # the bfloat16 instances: the same C entries on bfloat16 operands
    "window_gather_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/tile_gather.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:124",
    ),
    "window_gather_bwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/window_gather_bwd.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:156",
    ),
    "pt_attn_fwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:406",
    ),
    "pt_attn_bwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:830",
    ),
}
BF16 = torch.bfloat16
# each bfloat16 instance's kernel (wrapper, plain version, C entry)
BF16_KERNELS = {"window_gather_bf16": "window_gather",
                "window_gather_bwd_bf16": "window_gather_bwd",
                "pt_attn_fwd_bf16": "pt_attn_fwd", "pt_attn_bwd_bf16": "pt_attn_bwd"}
# the float32 batch-BN step's numbers recorded in PERF.md section 5 (NVIDIA
# H100 80GB HBM3, 700.00 W)
F32_STEP_PERF = "8.25 GB, 241.063 ms"
# each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "window_topk": (wt, "window_topk", wt.window_topk_plain),
    "window_gather": (tg, "window_gather", tg.window_gather_plain),
    "window_gather_bwd": (tg, "window_gather_bwd", tg.window_gather_bwd_plain),
    "cbl_stats_fwd": (cd, "cbl_stats_fwd", cd.cbl_stats_fwd_plain),
    "cbl_stats_bwd": (cd, "cbl_stats_bwd", cd.cbl_stats_bwd_plain),
    "pt_attn_fwd": (pa, "pt_attn_fwd", pa.pt_attn_plain),
    "pt_attn_bwd": (pa, "pt_attn_bwd", pa.pt_attn_bwd_plain),
    "cbl_tile2_fwd": (c2, "cbl_tile2_fwd", c2.cbl_tile2_fwd_plain),
    "cbl_tile2_bwd": (c2, "cbl_tile2_bwd", c2.cbl_tile2_bwd_plain),
    "cbl_tile_fwd": (c1, "cbl_tile_fwd", c1.cbl_tile_fwd_plain),
    "cbl_tile_bwd": (c1, "cbl_tile_bwd", c1.cbl_tile_bwd_plain),
    "gather_rows": (gd, "gather_rows", gd.gather_rows_plain),
}
SERVE_KERNELS = ("window_topk", "window_gather")
PATH_KERNELS = ("window_topk", "window_gather", "window_gather_bwd")
# the train step's CBL routes (losses/contrast.py): CBL_DENSE, ContrastConfig.impl
# and the CBL kernels each launches (the XLA tile route only adds gathers)
CBL_ROUTES = {
    "dense": (None, "xla", ("cbl_stats_fwd", "cbl_stats_bwd")),
    "xla": ("off", "xla", ()),
    "pallas": ("off", "pallas", ("cbl_tile2_fwd", "cbl_tile2_bwd")),
}
CBL_KERNELS = ("cbl_stats_fwd", "cbl_stats_bwd", "cbl_tile2_fwd", "cbl_tile2_bwd")
# kernels no path runs (as in the reference): every train run reads 0 of them
NO_PATH_KERNELS = ("cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
TRAIN_KERNELS = PATH_KERNELS + CBL_ROUTES["dense"][2]
STALE_SERVE_KERNELS = SERVE_KERNELS + ("pt_attn_fwd",)
STAGES = 5  # CBL stages of the flagship, one launch of each CBL kernel a stage
# the tolerances the CPU tests state between the routes' stage losses:
# dense against the XLA tile route (tests/test_torch_cbl.py), v2 against it
# (tests/test_torch_cbl_routes.py)
ROUTE_RTOL = {"dense": 3e-5, "pallas": 1e-5}
# attention layers of the flagship: 13 encoder blocks (blocks (2, 3, 4, 6, 3)
# less one transition a level) and 5 decoder blocks
ATTENTION_LAYERS = 18
TRAIN_SPEC = PyramidSpec(k_contrast=(36, 24, 24, 24, 24), with_subscene=True)
TRAIN_LR = 0.05
# phase 24's dataset and --set cuts (batch 16 -> 2, epochs 200 -> 1, loop
# 30 -> 2) and its instrumentation (every step's loss read and recorded)
ENTRY_ROOMS, ENTRY_POINTS = 4, 120_000
ENTRY_SETS = "optim.batch_size:2;optim.epochs:1;data.loop:2;eval.num_votes:1.0"
ENTRY_LOG = "log_freq:1"
# phase 26: raw ScanNet scenes of write_scannet_scene's default room (6 x 6 x
# 3 m) and the --set cuts of scannet_pt_cbl (the port's sorted layout and
# strided sampler; batch 16 -> 2, epochs 200 -> 1, loop 30 -> 2: 3 steps)
SCANNET_SCENES = 3
SCANNET_SETS = ("model.layout:sorted;model.sampler:strided;optim.batch_size:2;optim.epochs:1;"
                "data.loop:2")
SCANNET_CLASSES = 20
# gathers of a batch-BN bf16 step by dtype: the attention layers' kv rows are
# bfloat16; TransitionDown's [p | x], TransitionUp's and the head's rows and
# the training pyramid's and CBL's gathers come out of a BN or are float32
BF16_STEP_GATHERS = {"window_gather": {"bfloat16": ATTENTION_LAYERS, "float32": 21},
                     "window_gather_bwd": {"bfloat16": ATTENTION_LAYERS, "float32": 12}}


def base(name: str) -> str:
    """The kernel an entry of KERNELS runs (a bfloat16 instance's kernel)."""
    return BF16_KERNELS.get(name, name)


def split_bf16(calls: dict) -> dict:
    """Recorded calls with each kernel's bfloat16 calls (of its first
    operand: x, g or q) moved to its bfloat16 instance's entry."""
    out = dict(calls)
    for name, kernel in BF16_KERNELS.items():
        out[name] = [c for c in calls[kernel] if c[0][0].dtype == BF16]
        out[kernel] = [c for c in calls[kernel] if c[0][0].dtype != BF16]
    return out


def bf16_ulp(x):
    """One bfloat16 ulp at |x|: 2^(e − 8) for |x| = m·2^e, m in [0.5, 1)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def compare_bf16(name, got, ref, tol) -> float:
    """bfloat16 ``got`` within one bfloat16 ulp of ``ref`` plus ``tol`` of
    ref's scale (each side rounds its float32 value to bfloat16 once; the
    two float32 values differ by sum order, so they may round one ulp
    apart)."""
    d = (got.float() - ref.float()).abs()
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    ok = bool((d <= bf16_ulp(ref) + tol * scale).all())
    require(ok, f"{name} {tuple(got.shape)}: max|d|={float(d.max()):.3g}, scale {scale:.3g}")
    return float(d.max()) if d.numel() else 0.0


def bits(t):
    """The bits of a float32 or bfloat16 tensor, on the CPU."""
    return t.detach().cpu().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok {time.perf_counter() - t0:.3f} s", flush=True)


@contextmanager
def cbl_route_env(route: str):
    """The environment that selects a CBL route: CBL_DENSE as CBL_ROUTES
    gives it, unset for None."""
    value = CBL_ROUTES[route][0]
    with mock.patch.dict(os.environ):
        if value is None:
            os.environ.pop("CBL_DENSE", None)
        else:
            os.environ["CBL_DENSE"] = value
        yield


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def frozen(x, device=None):
    """A copy of a call's tensor arguments (the attention layer passes views
    of weights that the optimizer then updates in place), on ``device``
    where given."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone() if device is None else x.detach().to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(frozen(v, device) for v in x)
    if isinstance(x, dict):
        return {k: frozen(v, device) for k, v in x.items()}
    return x


@contextmanager
def recording():
    """Record every call (arguments as they were and the kernel's outputs)
    of the kernel wrappers made through the ops modules while active."""
    calls = {name: [] for name in WRAPPERS}
    with ExitStack() as stack:
        for name, (mod, attr, _) in WRAPPERS.items():
            def rec(*args, _fn=getattr(mod, attr), _name=name, **kw):
                out = _fn(*args, **kw)
                calls[_name].append((frozen(args), kw, out))
                return out
            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield calls


@contextmanager
def plain_kernels():
    """Swap every kernel for its plain PyTorch version."""
    with ExitStack() as stack:
        for mod, attr, plain in WRAPPERS.values():
            stack.enter_context(mock.patch.object(mod, attr, plain))
        yield


def reset_counts():
    wt.launches = tg.launches = tg.bwd_launches = 0
    for counts in (tg.dtype_launches, tg.bwd_dtype_launches, pa.fwd_dtype_launches,
                   pa.bwd_dtype_launches):
        counts.update(dict.fromkeys(counts, 0))
    cd.fwd_launches = cd.bwd_launches = 0
    pa.fwd_launches = pa.bwd_launches = 0
    c2.fwd_launches = c2.bwd_launches = c1.fwd_launches = c1.bwd_launches = 0
    gd.launches = 0
    knn.wide_calls = 0


def read_counts() -> dict:
    return {"window_topk": wt.launches, "window_gather": tg.launches,
            "window_gather_bwd": tg.bwd_launches, "cbl_stats_fwd": cd.fwd_launches,
            "cbl_stats_bwd": cd.bwd_launches, "pt_attn_fwd": pa.fwd_launches,
            "pt_attn_bwd": pa.bwd_launches, "cbl_tile2_fwd": c2.fwd_launches,
            "cbl_tile2_bwd": c2.bwd_launches, "cbl_tile_fwd": c1.fwd_launches,
            "cbl_tile_bwd": c1.bwd_launches, "gather_rows": gd.launches}


def read_dtype_counts() -> dict:
    """The gather and attention launches by the dtype of their operands."""
    return {"window_gather": dict(tg.dtype_launches),
            "window_gather_bwd": dict(tg.bwd_dtype_launches),
            "pt_attn_fwd": dict(pa.fwd_dtype_launches), "pt_attn_bwd": dict(pa.bwd_dtype_launches)}


def grid_cloud(rng, b, n, side=64):
    """Integer-grid cloud with duplicated rows: every distance is exact."""
    p = rng.integers(0, side, (b, n, 3)).astype(np.float32)
    for bb in range(b):
        p[bb, rng.integers(0, n, n // 8)] = p[bb, rng.integers(0, n, n // 8)]
    return p


def compare_topk(call, exact: bool) -> float:
    """Kernel output of a recorded call against the plain version."""
    (query, support, k), kw, (idx, val) = call
    p_idx, p_val = wt.window_topk_plain(query, support, k, **kw)
    err = float((val - p_val).abs().nan_to_num(0.0).max())
    same_inf = bool(torch.equal(torch.isinf(val), torch.isinf(p_val)))
    mismatch = float((idx != p_idx).float().mean())
    what = f"window_topk k={k} {kw}: max|dv|={err:.3g}, idx mismatch {mismatch:.3g}"
    if exact:
        require(torch.equal(idx, p_idx) and torch.equal(val, p_val), what)
    else:
        require(same_inf and err <= 1e-5 and mismatch <= 1e-4, what)
    return err


def compare_gather(call) -> float:
    """Bit for bit (float32 or bfloat16 rows)."""
    args, _, out = call
    ref = tg.window_gather_plain(*args)
    require(out.dtype == ref.dtype and torch.equal(bits(out), bits(ref)),
            f"window_gather {tuple(out.shape)} {out.dtype} differs")
    return 0.0


def compare_scaled(name, got, ref, tol) -> float:
    """max|got − ref| within ``tol`` of max|ref| (the output's scale)."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    require(err <= tol * scale, f"{name} {tuple(got.shape)}: max|d|={err:.3g}, scale {scale:.3g}")
    return err


def compare_gather_bwd(call) -> float:
    """Against the plain version on the card, whose index_add_ adds with
    atomics in no fixed order: 1e-5 of the output's scale, and exact on
    integer-valued cotangents at the same geometry (small integers sum
    exactly in any order). The kernel sums each row in slot order without
    atomics: the call run again gives the same bits, and so does the plain
    version on CPU copies (CPU index_add_ adds in index order)."""
    (g, li, starts, tile, width, ns), _, out = call
    what = f"window_gather_bwd {tuple(g.shape)} {g.dtype}"
    if g.dtype == BF16:  # one rounding of the plain version's float32 sum
        f32 = tg.window_gather_bwd_plain(g.float(), li, starts, tile, width, ns)
        err = compare_bf16("window_gather_bwd", out, f32, 0.0)
    else:
        err = compare_scaled("window_gather_bwd", out, tg.window_gather_bwd_plain(*call[0]), 1e-5)
    g_int = torch.randint_like(g, -3, 4)
    require(torch.equal(tg.window_gather_bwd(g_int, li, starts, tile, width, ns),
                        tg.window_gather_bwd_plain(g_int, li, starts, tile, width, ns)),
            f"{what} not exact on integer cotangents")
    require(torch.equal(bits(tg.window_gather_bwd(*call[0])), bits(out)),
            f"{what} differs between runs")
    cpu = tg.window_gather_bwd_plain(g.cpu(), li.cpu(), starts.cpu(), tile, width, ns)
    require(torch.equal(bits(cpu), bits(out)), f"{what} is not the plain version's CPU sum bit for bit")
    return err


def compare_stats_fwd(call) -> float:
    """Counts exact, the rest rel 1e-5 (the same arithmetic; exp and the
    sums over slots may round differently); the call run again gives the
    same bits on every lane (lane 0, m̂, is what the backward reads)."""
    args, _, out = call
    out = out.detach()
    ref = cd.cbl_stats_fwd_plain(*args)
    require(torch.equal(out[..., 3:], ref[..., 3:]), f"cbl_stats_fwd {tuple(out.shape)}: counts differ")
    err = float((out[..., :3] - ref[..., :3]).abs().max())
    require(bool(torch.allclose(out[..., :3], ref[..., :3], rtol=1e-5, atol=1e-7)),
            f"cbl_stats_fwd {tuple(out.shape)}: max|d|={err:.3g}")
    again = cd.cbl_stats_fwd(*args)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"cbl_stats_fwd {tuple(out.shape)}: differs between runs")
    return err


def compare_stats_bwd(call) -> float:
    """Against the plain version (1e-4 of the output's scale: the sums
    over a row's slots meet in another order, and the plain version's
    index_add_ adds with atomics on the card); the call run again gives the
    same bits (no atomics); the first pass's slot coefficients cd within
    1e-5 of their scale of the plain version's (the same roundings; exp may
    round otherwise)."""
    args, _, out = call
    what = f"cbl_stats_bwd {tuple(out.shape)}"
    err = compare_scaled(what, out, cd.cbl_stats_bwd_plain(*args), 1e-4)
    again, coef = cd.cbl_stats_bwd_passes(*args)
    bits = lambda t: t.cpu().view(torch.int32)
    require(torch.equal(bits(again), bits(out)), f"{what} differs between runs")
    compare_scaled(f"{what} pass-1 cd", coef, cd.cbl_bwd_cd_plain(*args)[0], 1e-5)
    return err


def compare_pt_attn_fwd(call) -> float:
    """out and both statistic pairs within 1e-4 of their scale (the kernel
    sums over slots and blocks in another order, and rounds exp otherwise);
    the call run again gives the same bits of all three (no atomics, the
    blocks' partial rows summed in order)."""
    args, _, got = call
    got = [t.detach() for t in got]
    ref = pa.pt_attn_plain(*args)
    again = pa.pt_attn_fwd(*args)
    err = 0.0
    for what, a, r, a2 in zip(("out", "s1", "s2"), got, ref, again):
        name = f"pt_attn_fwd {what} {tuple(a.shape)}"
        if a.dtype == BF16:  # a bfloat16 out: one rounding of each side's float32 out
            err = max(err, compare_bf16(name, a, r, 1e-4))
        else:
            err = max(err, compare_scaled(name, a, r, 1e-4))
        require(torch.equal(bits(a), bits(a2)), f"{name} differs between runs")
    return err


PT_GRADS = ("dq", "dkv", "dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2",
            "dW4", "db4")


def compare_pt_attn_bwd(call) -> float:
    """dq, dkv and the 12 parameter gradients within 1e-4 of their scale.
    db4 is zero in exact arithmetic (b4 shifts every slot's score alike,
    which a softmax ignores), so both values are rounding noise: it is held
    to 1e-4 of dW4's scale."""
    args, _, (dq, dkv, grads) = call
    r_dq, r_dkv, r_grads = pa.pt_attn_bwd_plain(*args)
    got, ref = (dq, dkv, *grads), (r_dq, r_dkv, *r_grads)
    err = 0.0
    for name, a, b in zip(PT_GRADS, got, ref):
        if a.dtype == BF16:  # dq and dkv of bfloat16 q and kv
            err = max(err, compare_bf16(f"pt_attn_bwd {name}", a, b, 1e-4))
            continue
        scale_of = ref[PT_GRADS.index("dW4")] if name == "db4" else b
        e = float((a - b).abs().max())
        require(e <= 1e-4 * float(scale_of.abs().max()),
                f"pt_attn_bwd {name} {tuple(a.shape)}: max|d|={e:.3g}, scale {float(scale_of.abs().max()):.3g}")
        err = max(err, e)
    return err


def check_pt_attn_bwd_exact(call):
    """dkv exact on integer-valued cotangents: with W4 = 0 every score is
    b4, so att = 1/K and d(v + pe) = g/K are exact dyadic numbers, and the
    atomics' sums of them are exact in any order (dk is then exactly 0)."""
    (q, kv, rel, li, starts, tile, width, params, g), _, _ = call
    ps = list(params)
    ps[10] = torch.zeros_like(ps[10])
    g_int = torch.randint_like(g, -3, 4)
    dkv = pa.pt_attn_bwd(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    ref = pa.pt_attn_bwd_plain(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    require(torch.equal(dkv, ref), f"pt_attn_bwd dkv {tuple(dkv.shape)} not exact on integer cotangents")


def compare_tile_stats(name, call) -> float:
    """Per-row statistics of a CBL tile kernel call (v2 or v1) against its
    plain version: the counts and the mask exact on every row, the max, the
    sums and loss·mask within 1e-4 of each lane's scale (the distances are
    rounded in one order on both sides; exp and log may round otherwise on
    the card). The kernels compute the max and the sums (lanes 0-2) only on
    the rows of the mask: there they are held so, elsewhere they must be the
    fill (0, 0, 0) with lane 5 zero (no output reads them there); lane 7 is
    0; the call run again gives the same bits on every lane."""
    args, kw, out = call
    mod, attr, plain = WRAPPERS[name]
    ref = plain(*args, **kw)
    exact = [3, 4, 6]
    require(torch.equal(out[..., exact], ref[..., exact]),
            f"{name} {tuple(out.shape)}: counts or mask differ")
    mask = out[..., 6] > 0
    require(not out[~mask][:, [0, 1, 2, 5]].any() and not out[..., 7].any(),
            f"{name} {tuple(out.shape)}: not the fill outside the mask")
    again = getattr(mod, attr)(*args, **kw)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"{name} {tuple(out.shape)}: differs between runs")
    return max(compare_scaled(f"{name} lane {i} (masked rows)", out[mask][:, i], ref[mask][:, i],
                              1e-4) for i in (0, 1, 2, 5))


def compare_tile_grad(name, call) -> float:
    """A CBL tile backward call against its plain version: 1e-4 of the
    output's scale (the sums meet in another order, and the plain version's
    index_add_ adds with atomics on the card). Neither form has atomics: the
    call run again gives the same bits. v2's first pass's slot
    coefficients, on the rows it serves, are within 1e-5 of their scale of
    the plain version's (the same roundings; exp may round otherwise). v1
    runs v2's kernels on its split of the fused rows: its label columns are
    zero and its feature columns are v2's backward bit for bit on the
    split's features and meta (``cbl_tile.split_plain``) with the same
    statistics."""
    args, kw, out = call
    if name == "cbl_tile_bwd":
        fused, li, stats, g, ncls = args[:5]
        what = f"{name} {tuple(out.shape)}"
        require(not out[..., :ncls].any(), f"{what}: a label column has a gradient")
        again = c1.cbl_tile_bwd(*args, **kw)
        require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                f"{what} differs between runs")
        meta = c1.split_plain(fused, ncls)[1]
        v2 = c2.cbl_tile2_bwd(fused[..., ncls:], meta, li, stats, g, *args[5:])
        require(torch.equal(out[..., ncls:].contiguous().view(torch.int32), v2.view(torch.int32)),
                f"{what}: the feature columns are not v2's backward bit for bit")
    else:
        again, coef = c2.cbl_tile2_bwd_passes(*args, **kw)
        require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                f"{name} {tuple(out.shape)}: differs between runs")
        features, meta, li, stats, g = args[:5]
        served = (stats[..., 6] != 0) & (g[:, None] != 0)  # pass 1 writes their slots
        ref = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats, g,
                                  *args[5:])[0]
        compare_scaled(f"{name} {tuple(out.shape)} pass-1 coef", coef[served], ref[served], 1e-5)
    return compare_scaled(name, out, WRAPPERS[name][2](*args, **kw), 1e-4)


def compare_call(name, call, exact_topk=False) -> float:
    name = base(name)
    if name in ("cbl_tile2_fwd", "cbl_tile_fwd"):
        return compare_tile_stats(name, call)
    if name in ("cbl_tile2_bwd", "cbl_tile_bwd"):
        return compare_tile_grad(name, call)
    if name == "gather_rows":
        args, _, out = call
        require(torch.equal(out, gd.gather_rows_plain(*args)), "gather_rows differs")
        return 0.0
    if name == "pt_attn_fwd":
        return compare_pt_attn_fwd(call)
    if name == "pt_attn_bwd":
        return compare_pt_attn_bwd(call)
    if name == "window_topk":
        return compare_topk(call, exact_topk)
    if name == "window_gather":
        return compare_gather(call)
    if name == "window_gather_bwd":
        return compare_gather_bwd(call)
    if name == "cbl_stats_fwd":
        return compare_stats_fwd(call)
    return compare_stats_bwd(call)


def check_kernels(dev, points_sets) -> float:
    """Phase 2: every kernel call of the eval pyramid of each cloud."""
    err = 0.0
    spec = PyramidSpec()
    for name, pts, exact in points_sets:
        with recording() as calls:
            build_pyramid(torch.as_tensor(pts, device=dev), spec)
        for c in calls["window_topk"]:
            err = max(err, compare_topk(c, exact))
        for c in calls["window_gather"]:
            err = max(err, compare_gather(c))
        print(f"  {name}: {len(calls['window_topk'])} window_topk and "
              f"{len(calls['window_gather'])} window_gather calls agree "
              f"({'exact' if exact else 'tolerance'})", flush=True)
    return err


def check_topk_modes(dev, pts) -> float:
    """window_topk where no eval or train geometry takes it (the train and
    serve paths use the plain and ensure_self modes with k <= W): k > W in
    the self and cross geometries, and exclude_self with k <= W and k > W,
    on an integer-grid cloud, held to exact equality."""
    p = torch.as_tensor(pts, device=dev)
    small = p[:, :2048].contiguous()
    cases = (
        ("exclude_self", p, p, 16, dict(tile=256, width=3, window=1)),
        ("plain", small, small, 12, dict(tile=8, width=1, window=0)),
        ("exclude_self", small, small, 12, dict(tile=8, width=1, window=0)),
        ("plain", p[:, ::4].contiguous(), p, 300, dict(tile=256, width=1, window=0)),
    )
    for mode, query, support, k, geo in cases:
        kw = dict(geo, mode=mode)
        out = wt.window_topk(query, support, k, **kw)
        compare_topk(((query, support, k), kw, out), exact=True)
        print(f"  window_topk mode={mode} k={k} W={geo['tile'] * geo['width']} "
              f"M={query.shape[1]} Ns={support.shape[1]}: equal to the plain version", flush=True)
    return 0.0


GATHER_WIDTHS = (1, 2, 3, 5, 35, 67, 131, 259, 1024)


def check_gather_widths(dev) -> float:
    """window_gather at the widths of GATHER_WIDTHS, in the self geometry
    (tile 256, width 3, K 16) and the cross one (16384 queries on 65536
    support rows, width 6, K 3), with repeated and shadow slots, and at C =
    1024 from an x that is not 16-byte aligned (the scalar-read path at C %
    4 == 0): each equal to the plain version."""
    rng = np.random.default_rng(6)
    tile = 256
    cases = []
    for c in GATHER_WIDTHS:
        for m, ns, k, width, window in ((4096, 4096, 16, 3, 1), (16384, 65536, 3, 6, 1)):
            if c == 1024 and ns == 65536:
                continue  # 2 GB of output; the self case covers the width
            cases.append((c, m, ns, k, width, window, 0))
    cases.append((1024, 4096, 4096, 16, 3, 1, 1))
    for c, m, ns, k, width, window, shift in cases:
        buf = torch.as_tensor(rng.standard_normal(B * ns * c + shift, dtype=np.float32), device=dev)
        x = buf[shift:].view(B, ns, c)
        w_sz = width * tile
        li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
        li[:, ::7, -1] = w_sz  # shadow slots
        starts = wt.window_start_tiles(m // tile, ns // tile, width, window)
        li_t = torch.as_tensor(li, device=dev)
        st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        out = tg.window_gather(x, li_t, st, tile, width)
        compare_gather(((x, li_t, st, tile, width), {}, out))
        plan = tg.gather_plan(B * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        print(f"  window_gather C={c} x {tuple(x.shape)}{' misaligned' if shift else ''} idx "
              f"{tuple(li.shape)} W={w_sz} {plan}: equal to the plain version", flush=True)
    return 0.0


def random_flax_tree(model, seed: int) -> dict:
    """Seeded random weights as a flax tree for the converter (used only when
    the checkpoint file is absent)."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        shape = tuple(v.shape)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", "mean" if leaf == "running_mean" else "var"
            a = rng.random(shape) + 0.5 if name == "var" else 0.1 * rng.standard_normal(shape)
        elif leaf == "weight" and isinstance(mod, torch.nn.Linear):
            coll, name = "params", "kernel"
            a = rng.standard_normal(shape[::-1]) / np.sqrt(shape[1])
        else:
            coll, name = "params", "scale" if leaf == "weight" else "bias"
            a = 1.0 + 0.1 * rng.standard_normal(shape) if name == "scale" else 0.1 * rng.standard_normal(shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a.astype(np.float32)
    return tree


def load_model(bn_mode="batch", dtype=torch.float32):
    model = PointTransformerSeg(num_classes=NUM_CLASSES, bn_mode=bn_mode, dtype=dtype)
    if CKPT.exists():
        return load_jax_variables(model, load_checkpoint(str(CKPT))), True
    print(f"checkpoint {CKPT} is absent: seeded random weights, no accuracy floor",
          flush=True)
    return load_jax_variables(model, random_flax_tree(model, 0)), False


def room0(seed=0):
    return SyntheticSceneDataset(num_rooms=1, points_per_room=120_000, seed=seed, split="val")


def time_ms(fn, flush_buf=None, reps=10) -> float:
    """Mean device time of fn over reps runs (CUDA events), each after an L2
    flush when flush_buf is given."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush_buf is not None:
            flush_buf.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def topk_library_call(query, support, k, *, tile, width, window, mode="plain"):
    """torch.topk over the window distance tensor (built outside the timed
    call): the library yardstick, which leaves out the distances."""
    b, m, _ = query.shape
    gq, gs = m // tile, support.shape[1] // tile
    starts = torch.as_tensor(wt.window_start_tiles(gq, gs, width, window), device=query.device)
    cols = starts[:, None] + torch.arange(width, device=query.device)[None, :]
    win = support.reshape(b, gs, tile, 3)[:, cols].reshape(b, gq, width * tile, 3)
    neg = -torch.cdist(query.reshape(b, gq, tile, 3), win).square()
    kk = min(k, width * tile)
    return lambda: torch.topk(neg, kk, dim=-1)


def gather_library_call(x, local_idx, starts, tile, width):
    """x[b, rows] advanced indexing with the global rows built outside the
    timed call (shadow rows read row 0 instead of zeros)."""
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(x.shape[1] - 1)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return lambda: x[bidx, rows]


def gather_bwd_library_call(g, local_idx, starts, tile, width, n_support):
    """index_add_ of g's rows onto zeros with the global rows built outside
    the timed call (shadow slots add onto row 0 instead of nothing); for a
    bfloat16 g, the float32 index_add_ of g.float(), then .to(bfloat16)."""
    b, m, k, c = g.shape
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(n_support - 1)
    rows = (rows + torch.arange(b, device=g.device)[:, None, None] * n_support).reshape(-1)
    src = g.reshape(-1, c)
    if g.dtype == BF16:
        return lambda: torch.zeros(b * n_support, c, device=g.device).index_add_(
            0, rows, src.float()).to(BF16)
    return lambda: torch.zeros(b * n_support, c, device=g.device).index_add_(0, rows, src)


def tile_costs(name, args, out):
    """(bytes, FP32 operations, shape) that a CBL tile kernel call's function
    needs on this call's data. Every row's li and label (v2: meta lanes 0
    and 1; v1: its ncls label columns) decide the slot counts and so the
    loss mask. Only the rows of the mask (in the backward: with a cotangent
    != 0) need their features, the labels and features of the rows their
    slots name (features of the valid ones), the distances and the sums.
    The forward's outputs are the two [B] sums (not the statistics it keeps
    for the backward); the backward reads every row's statistics and writes
    its whole gradient. Operations: a label's argmax and sum 2·ncls a row
    (v1), 4 a valid slot for the counts; per valid slot of a masked row the
    distance 3C + 2 and the max, exp and sums ~26 forward, ~6C + 70
    backward."""
    v1, fwd = name.startswith("cbl_tile_"), name.endswith("fwd")
    x, li = (args[0], args[1]) if v1 else (args[0], args[2])
    ncls = (args[2] if fwd else args[4]) if v1 else 0
    tile, width, window = args[-3:]
    b, m, k = li.shape
    c = x.shape[-1] - ncls
    valid = x[..., :ncls].sum(-1) > 0 if v1 else args[1][..., 1] > 0
    stats = out if fwd else args[2] if v1 else args[3]
    mask = stats[..., 6] > 0
    if not fwd:
        mask &= (args[3] if v1 else args[4])[:, None] != 0
    starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=x.device)
    rows, member = tg._rows(li, starts, tile, width, m)
    slot_ok = member & valid.reshape(-1)[rows]
    m_rows, m_member, m_ok = rows[mask], member[mask], slot_ok[mask]
    q_rows = torch.nonzero(mask.reshape(-1)).squeeze(1)
    named = int(torch.unique(torch.cat([q_rows, m_rows[m_member]])).numel())
    need = int(torch.unique(torch.cat([q_rows, m_rows[m_ok]])).numel())
    n_mask, n_masked_slots = int(mask.sum()), float(m_ok.sum())
    label_bytes = 4 * ncls if v1 else 8
    if fwd:
        n_bytes = b * m * (4 * k + label_bytes) + 4 * c * need + 8 * b
        n_ops = b * m * 2 * ncls + 4 * float(slot_ok.sum()) + n_masked_slots * (3 * c + 28)
    else:
        n_bytes = (b * m * (32 + 4 * x.shape[-1]) + 4 * b + 4 * k * n_mask
                   + label_bytes * named + 4 * c * need)
        n_ops = named * 2 * ncls + n_masked_slots * (6 * c + 70)
    shape = dict(rows=list(x.shape), K=k, ncls=ncls, masked_rows=n_mask,
                 masked_valid_slots=int(n_masked_slots), rows_read=need)
    return float(n_bytes), float(n_ops), shape


def attn_slot_ops(c: int, cs: int) -> tuple:
    """FP32 operations a slot-row of the fused attention needs, (forward,
    backward), counted from the plain versions: a product over n inputs is
    2n with its bias add, a ReLU or mask 1 an element.
    Forward: the PE tower 21 + 6C; w_pre and the bn1 affine 4C, ReLU C; fc1
    2C·Cs; the bn2 affine and ReLU 3Cs; fc2 2Cs²; the softmax over the
    slots 5Cs (max, subtract, exp, sum, divide) on the Cs weight channels;
    Σ att·(v + pe) 3C; the statistics 3C + 3Cs.
    Backward: the forward up to the softmax again; g·(v + pe) and dalpha
    3C, S and dw4 4Cs, dvpe C; dW4 and dc_ 4Cs² + Cs, db4 Cs; dg2, dh2 and
    dbv 4Cs; dW3 and db3 2C·Cs + Cs; da 2C·Cs + C; dg1, dh1 and dw_pre 4C;
    dq C; dk|dv 2C; dpe C; dW2 and db2 7C; dr_pe 6C + 3; dA1 and dc1 21."""
    fwd = 21 + 17 * c + 2 * c * cs + 2 * cs * cs + 11 * cs
    bwd = 45 + 37 * c + 6 * c * cs + 6 * cs * cs + 19 * cs
    return fwd, bwd


def call_costs(name, call):
    """(kernel fn, plain fn, library fn or None, bytes, operations, shape)
    of one recorded call."""
    args, kw, out = call
    name = base(name)
    mod, attr, plain_fn = WRAPPERS[name]
    kern = lambda: getattr(mod, attr)(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        w_sz = kw["width"] * kw["tile"]
        n_bytes = 4 * (query.numel() + support.numel()) + 8 * b * m * k
        n_ops = 10.0 * b * m * w_sz  # 9 FLOPs of distance + 1 compare a pair
        shape = dict(k=k, B=b, M=m, Ns=support.shape[1], W=w_sz, mode=kw.get("mode", "plain"))
        return kern, plain, topk_library_call(query, support, k, **kw), n_bytes, n_ops, shape
    size = lambda t: t.element_size() * t.numel()  # bytes, at the tensor's dtype
    if name == "window_gather":
        x, li, starts, tile, width = args
        n_bytes = size(x) + size(li) + size(starts) + size(out)
        shape = dict(x=list(x.shape), idx=list(li.shape), W=tile * width, dtype=str(x.dtype))
        return kern, plain, gather_library_call(*args), n_bytes, 0.0, shape
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        n_bytes = size(g) + size(li) + size(starts) + size(out)
        shape = dict(g=list(g.shape), Ns=ns, W=tile * width, dtype=str(g.dtype))
        return kern, plain, gather_bwd_library_call(*args), n_bytes, float(g.numel()), shape
    if name in ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd"):
        n_bytes, n_ops, shape = tile_costs(name, args, out)
        return kern, plain, None, n_bytes, n_ops, shape
    if name == "gather_rows":
        # idx read once, the distinct rows it names read once, out written once
        x, idx = args[:2]
        rows = int(torch.unique(idx).numel())
        n_bytes = 4 * idx.numel() + x.element_size() * x.shape[1] * (rows + idx.numel())
        idx_long = idx.long()
        shape = dict(x=list(x.shape), M=idx.numel(), distinct_rows=rows)
        return (kern, plain, lambda: torch.index_select(x, 0, idx_long), n_bytes, 0.0,
                shape)
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        # inputs read once, outputs written once, each at its dtype (q, kv,
        # out, g_out, dq and dkv bfloat16 in a bf16 call); FP32 operations of
        # the plain versions' slot-rows (attn_slot_ops)
        q, kv, rel, li, starts, tile, width, params = args[:8]
        b, m, c = q.shape
        k, cs = li.shape[-1], params[6].shape[-1]
        fwd_ops, bwd_ops = attn_slot_ops(c, cs)
        nbytes = lambda ts: sum(size(t) for t in ts)
        n_bytes = nbytes((q, kv, rel, li, starts)) + nbytes(params)
        if name == "pt_attn_fwd":
            n_bytes += nbytes(out)
            n_ops = b * m * k * fwd_ops
        else:
            dq, dkv, grads = out
            n_bytes += nbytes((args[8], dq, dkv)) + nbytes(grads)
            n_ops = b * m * k * bwd_ops
        shape = dict(B=b, M=m, C=c, K=k, W=tile * width, dtype=str(q.dtype))
        return kern, plain, None, n_bytes, float(n_ops), shape
    # stats: inputs read once, outputs written once; per valid listed slot
    # about 4C + 12 FP32 operations forward and 8C + 16 backward
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    valid = float(cd.cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)[..., 4].sum())
    c = features.shape[-1]
    n_bytes = 4 * (features.numel() + meta.numel() + li.numel())
    if name == "cbl_stats_fwd":
        n_bytes += 4 * out.numel()
        n_ops = valid * (4 * c + 12)
    else:
        # the forward's m̂ (one lane of its stats), the cotangent, dx
        n_bytes += 4 * (features.shape[0] * features.shape[1] + args[4].numel() + out.numel())
        n_ops = valid * (8 * c + 16)
    shape = dict(features=list(features.shape), K=li.shape[-1], tile=tile, width=width,
                 valid_slots=int(valid))
    return kern, plain, None, n_bytes, n_ops, shape


@torch.no_grad()
def time_calls(calls, dev, launches, max_err, names, reps=10, records=None) -> list:
    """Hold each recorded launch against the plain version, then time it;
    per-kernel sums over the recorded run (and, into ``records`` where
    given, (name, shape, kernel ms, bound ms) of each launch)."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    summary = []
    for name in names:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
        has_lib = True
        for call in calls[name]:
            max_err[name] = max(max_err[name], compare_call(name, call))
            kern, plain, lib, n_bytes, n_ops, shape = call_costs(name, call)
            t_k, t_p = (time_ms(f, flush_buf, reps) for f in (kern, plain))
            t_l = None if lib is None else time_ms(lib, flush_buf, reps)
            has_lib = has_lib and t_l is not None
            bnd, t_b, t_o = bound_ms(n_bytes, n_ops)
            lib_txt = "n/a" if t_l is None else f"{t_l:.4f} ms"
            print(f"  {name} {shape}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"library {lib_txt}, bound {bnd:.5f} ms", flush=True)
            if records is not None:
                records.append((base(name), shape, t_k, bnd))
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l or 0.0),
                           ("bound_ms", bnd), ("t_bytes", t_b), ("t_ops", t_o)):
                tot[key] += v
        summary.append(dict(
            name=name, route="cuda", **KERNELS[name], launches=launches[name],
            max_abs_err=max_err[name], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by="operations" if tot["t_ops"] > tot["t_bytes"] else "bytes",
            library_ms=tot["library_ms"] if has_lib else None,
        ))
    return summary


def profile_request(step, batch, top=12, what="request"):
    """One request (or train step) under torch.profiler: device time by
    kernel name and the device's busy share of its wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device events only; "Optimizer.step#SGD.step"-style names are the
    # profiler's own annotations spanning kernels, not device work (kernel
    # names hold spaces or parentheses)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    events = sorted(kernels, key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_dev = sum(e.count for e in events)
    print(f"profiled {what}: {n_dev} device events, wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in events[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)
    return busy_ms


def snapshot(model, opt):
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def restore(model, opt, snap):
    model.load_state_dict(snap[0])
    opt.load_state_dict(copy.deepcopy(snap[1]))  # the optimizer keeps what it is given


def grad_norm(model) -> float:
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in model.parameters() if p.grad is not None)))


def buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def run_train(dev, bn_mode="batch", route="dense", dtype=torch.float32) -> dict:
    """Phases 8, 10, 12, 13, 17 and 18: the flagship train step at B x N from
    the checkpoint, with flax batch BN or stale BN, on one of the CBL routes
    (the caller selects it with cbl_route_env), float32 or bfloat16. The
    kernel-vs-plain step tolerances of a bfloat16 step (loss 1e-3, gradient
    norm and running statistics 1e-2) allow for the values that the
    kernels' and the plain versions' float32 sums, in their different
    orders, leave at a bfloat16 rounding boundary: those round one ulp
    (2^-8) apart and move the step further than float32 order does."""
    _, impl, cbl_kernels = CBL_ROUTES[route]
    require(cbl_losses.dense_route() == (route == "dense"), f"CBL_DENSE does not select {route}")
    kernels = PATH_KERNELS + cbl_kernels
    if bn_mode == "stale":
        kernels += ("pt_attn_fwd", "pt_attn_bwd")
    bf16 = dtype == BF16
    what = f"{bn_mode} BN" + ("" if route == "dense" else f", CBL route {route}") + (
        ", bfloat16" if bf16 else "")
    model, trained = load_model(bn_mode, dtype)
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC,
                          contrast=ContrastConfig(impl=impl))
    step = make_train_step(model, cfg, opt, device=dev)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    snap0 = snapshot(model, opt)
    step(batch)  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print("  step: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items()
                                      if k != "confusion"), flush=True)
    med = statistics.median(secs[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({what}) median of 3 warm steps {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, what="train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step "
          f"{med * 1e3:.3f} ms: busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    if route == "dense":  # the pyramid is the same on every route
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, TRAIN_SPEC), reps=3)
        print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)

    restore(model, opt, snap0)
    torch.cuda.synchronize()
    reset_counts()
    wide_args, wide_fn = [], knn.window_topk_wide
    stage_inputs, v2_fn = [], cbl_losses.cbl_tile_softnn2

    def rec_wide(*args, **kw):
        wide_args.append((args, kw))
        return wide_fn(*args, **kw)

    def rec_v2(*args, **kw):
        stage_inputs.append(frozen(args))
        return v2_fn(*args, **kw)

    with recording() as calls, mock.patch.object(knn, "window_topk_wide", rec_wide), \
            mock.patch.object(cbl_losses, "cbl_tile_softnn2", rec_v2):
        m = step(batch)
        torch.cuda.synchronize()
    counts, wide, by_dtype = read_counts(), knn.wide_calls, read_dtype_counts()
    launches = {k: counts[k] for k in kernels}
    print(f"launches in one train step ({what}): {launches}; wide-window searches "
          f"(plain PyTorch): {wide}; by dtype {by_dtype}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(all(launches[k] == STAGES for k in cbl_kernels),
            f"not one launch of each CBL kernel a stage: {launches}")
    others = {k: counts[k] for k in CBL_KERNELS if k not in cbl_kernels}
    require(not any(others.values()), f"another route's CBL kernel was launched: {others}")
    no_path = {k: counts[k] for k in NO_PATH_KERNELS}
    require(not any(no_path.values()), f"a kernel of no path was launched: {no_path}")
    metrics = {k: float(v) for k, v in m.items() if k != "confusion"}
    for args, kw in wide_args if route == "dense" else ():
        t = time_ms(lambda: wide_fn(*args, **kw), reps=3)
        print(f"  wide-window search k={args[2]} M={args[0].shape[1]} "
              f"W={kw['width'] * kw['tile']}: {t:.4f} ms", flush=True)
    loss_k, gn_k, stats_k = float(m["loss"]), grad_norm(model), buffers(model)
    require(np.isfinite(loss_k) and np.isfinite(gn_k), f"loss {loss_k}, grad norm {gn_k}")
    restore(model, opt, snap0)
    with plain_kernels():
        m = step(batch)
    loss_p, gn_p, stats_p = float(m["loss"]), grad_norm(model), buffers(model)
    stats_rel = max(float((stats_k[n] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                    for n, v in stats_p.items())
    print(f"kernels vs plain, same weights and batch: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}), gradient norm {gn_k:.7f} vs "
          f"{gn_p:.7f} (rel {abs(gn_k - gn_p) / gn_p:.3g}), running statistics rel "
          f"{stats_rel:.3g}", flush=True)
    tol_loss, tol_gn, tol_stats = (1e-3, 1e-2, 1e-2) if bf16 else (1e-4, 1e-3, 1e-4)
    require(abs(loss_k - loss_p) <= tol_loss * abs(loss_p), "train losses disagree")
    require(abs(gn_k - gn_p) <= tol_gn * gn_p, "gradient norms disagree")
    require(stats_rel <= tol_stats, "running statistics disagree")
    return dict(calls=calls, launches=launches, model=model, step=step, peak=peak, med=med,
                metrics=metrics, stage_inputs=stage_inputs, no_path=no_path, loss=loss_k,
                grad_norm=gn_k, busy_ms=busy_ms, by_dtype=by_dtype)


def check_train_kernels(dev, train) -> list:
    """Phase 9: every kernel call of one train step on integer-grid clouds
    (exact top-k) against the plain versions; then every call of the
    recorded step compared and timed."""
    rng = np.random.default_rng(2)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    max_err = {name: 0.0 for name in WRAPPERS}
    with recording() as calls:
        train["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name, cs in calls.items():
            for c in cs:
                max_err[name] = max(max_err[name], compare_call(name, c, exact_topk=True))
            print(f"  integer grid: {len(cs)} {name} calls agree", flush=True)
    del calls
    summary = time_calls(train["calls"], dev, train["launches"], max_err, TRAIN_KERNELS, reps=5)
    time_spread(train["calls"], dev,
                ("window_topk", "window_gather", "window_gather_bwd", "cbl_stats_fwd",
                 "cbl_stats_bwd"))
    return summary


def check_stale_kernels(dev, stale) -> list:
    """Phase 11: every pt_attn call of the recorded stale step against the
    plain versions; one stale step on integer-grid clouds, each of its
    backward calls also exact on integer cotangents; then each call of the
    recorded step timed as in phase 4."""
    max_err = {name: 0.0 for name in ("pt_attn_fwd", "pt_attn_bwd")}
    rng = np.random.default_rng(3)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    with recording() as calls:
        stale["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name in max_err:
            for c in calls[name]:
                max_err[name] = max(max_err[name], compare_call(name, c))
        for c in calls["pt_attn_bwd"]:
            check_pt_attn_bwd_exact(c)
    print(f"  integer grid: {len(calls['pt_attn_fwd'])} pt_attn_fwd and "
          f"{len(calls['pt_attn_bwd'])} pt_attn_bwd calls agree, dkv exact on integer "
          f"cotangents", flush=True)
    del calls
    records = []
    summary = time_calls(stale["calls"], dev, stale["launches"], max_err, tuple(max_err), reps=5,
                         records=records)
    print_widths(records)
    time_spread(stale["calls"], dev, tuple(max_err))
    return summary


def print_widths(records) -> None:
    """The attention kernels' recorded launch times summed per width (C, M,
    K): launches, kernel ms, bound ms."""
    widths = {}
    for name, shape, t_k, bnd in records:
        w = widths.setdefault((name, shape["C"], shape["M"], shape["K"]), [0, 0.0, 0.0])
        w[0] += 1
        w[1] += t_k
        w[2] += bnd
    for (name, c, m, k), (n, t_k, bnd) in sorted(widths.items()):
        print(f"  {name} C={c} M={m} K={k}: {n} launches, {t_k:.4f} ms, bound {bnd:.5f} ms "
              f"({t_k / bnd:.1f}x)", flush=True)


def attn_inputs(dev, rng, c, m, k, tile, width):
    """Seeded operands of one attention call at B clouds: tower arrays about
    as the folded flagship's (bn scales near 1), slot 0 the query row, the
    slots beyond the largest power of two <= K shadow slots in every row (so
    that the valid slots' equal weights are dyadic where W4 = 0, as
    check_pt_attn_bwd_exact needs), and a cotangent."""
    cs = c // pa.SHARES
    w_sz = tile * width

    def a(shape, scale=0.3, off=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale + off).astype(np.float32),
                               device=dev)

    params = (a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), off=1.0), a((1, c)),
              a((c, cs), c ** -0.5), a((1, cs)), a((1, cs), off=1.0), a((1, cs)),
              a((cs, cs), cs ** -0.5), a((1, cs)))
    starts = window_starts(m // tile, width)
    li = rng.integers(0, w_sz, (B, m, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(m) - np.repeat(starts * tile, tile))[None]
    li[:, :, 1 << (k.bit_length() - 1):] = w_sz
    args = (a((B, m, c), 1.0), a((B, m, 2 * c), 1.0), a((B, m, k, 3), 0.05),
            torch.as_tensor(li, device=dev), torch.as_tensor(starts, dtype=torch.int32, device=dev),
            tile, width, params)
    return args, a((B, m, c), 1.0)


# direct v2 calls of phase plan-shapes: (C, M, K, tile, width, window, labels)
# with labels "mixed" (4 classes, 10% of the rows without a label), "all"
# (every row in the loss mask: slot 0 the query, slot 1 a row of the other
# label) or "none" (one label: no row in the mask)
V2_SHAPES = (
    (1, 4096, 35, 256, 3, 1, "mixed"), (20, 4096, 35, 256, 3, 1, "mixed"),
    (33, 4096, 35, 256, 3, 1, "mixed"), (64, 4096, 1, 256, 3, 1, "mixed"),
    (128, 4096, 300, 256, 3, 1, "mixed"), (32, 4096, 300, 256, 3, 1, "all"),
    (32, 8192, 35, 128, 5, 2, "mixed"), (32, 8192, 35, 1024, 1, 0, "all"),
    (32, 4096, 35, 256, 3, 1, "none"),
    # M·K >= 2^23, and a support tile's slot range beyond the scatter's 2^22
    (32, 32768, 300, 4096, 4, 1, "mixed"),
)


def v2_inputs(dev, rng, c, m, k, tile, width, window, labels):
    """Seeded operands of a direct v2 call at B clouds → (features, meta,
    li, temperature, tile, width, window) and a cotangent g [B]."""
    w_sz = tile * width
    q = np.arange(m)
    own = q - np.repeat(cd.self_window_starts(m, tile, width, window) * tile, tile)
    if labels == "mixed":
        lab = rng.integers(0, 4, (B, m))
        valid = rng.random((B, m)) >= 0.1
    else:
        lab = np.broadcast_to(q % 2 if labels == "all" else 0 * q, (B, m))
        valid = np.ones((B, m), bool)
    onehot = np.eye(4, dtype=np.float32)[lab] * valid[..., None]
    li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
    if labels == "all":
        li[:, :, 0] = own
        li[:, :, 1] = np.where(own + 1 < w_sz, own + 1, own - 1)
    t = lambda a: torch.as_tensor(a, device=dev)
    features = t(rng.standard_normal((B, m, c), dtype=np.float32))
    args = (features, cd.row_meta(t(onehot)), t(li), 0.5, tile, width, window)
    return args, t(rng.standard_normal(B).astype(np.float32))


def check_v2_shapes(dev, rng) -> None:
    """The v2 kernels at V2_SHAPES against their plain versions, as in phase
    cbl-kernels: every shape the previous kernels took has a plan."""
    for c, m, k, tile, width, window, labels in V2_SHAPES:
        args, g = v2_inputs(dev, rng, c, m, k, tile, width, window, labels)
        stats = c2.cbl_tile2_fwd(*args)
        n_mask = int(stats[..., 6].sum())
        if labels == "all":
            require(n_mask == B * m, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not all")
        if labels == "none" or k == 1:
            require(n_mask == 0, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not none")
        err = compare_tile_stats("cbl_tile2_fwd", (args, {}, stats))
        bwd_args = args[:3] + (stats, g) + args[3:]
        dx = c2.cbl_tile2_bwd(*bwd_args)
        require(dx.shape == args[0].shape, f"v2 gradient {tuple(dx.shape)}")
        err = max(err, compare_tile_grad("cbl_tile2_bwd", (bwd_args, {}, dx)))
        plan = c2.bwd_plan(B, m, k, c, tile)
        print(f"  cbl_tile2 C={c} M={m} K={k} tile {tile} x width {width} ({labels}, {n_mask} "
              f"masked rows): fwd plan {tuple(c2.fwd_plan(B, m, k, c))}, scatter rows "
              f"{plan.scatter_rows}: max|d| {err:.3g}, the same bits twice", flush=True)
        del args, stats, dx
        torch.cuda.empty_cache()


# direct v1 calls of phase plan-shapes: (C, ncls, K), M = 4096, tile 256 x
# width 3, window 1, soft labels in halves (ties among the label columns), 10%
# of the rows without a label; ncls = 1 gives one class and no masked row
V1_SHAPES = ((1, 13, 35), (32, 1, 35), (32, 40, 35), (33, 13, 1), (33, 40, 35),
             (128, 13, 35), (128, 40, 1), (32, 13, 1))


def check_v1_shapes(dev, rng) -> None:
    """v1 at V1_SHAPES against its plain version, as in phase cbl-kernels
    (compare_tile_stats, compare_tile_grad): the split takes any ncls and
    every C the plans take."""
    m, tile, width, window = 4096, 256, 3, 1
    for c, ncls, k in V1_SHAPES:
        lab = rng.integers(0, 3, (B, m, ncls)).astype(np.float32) / 2
        lab[rng.random((B, m)) < 0.1] = 0.0
        feats = rng.standard_normal((B, m, c), dtype=np.float32)
        fused = torch.as_tensor(np.concatenate([lab, feats], -1), device=dev)
        li = torch.as_tensor(rng.integers(0, tile * width + 1, (B, m, k)).astype(np.int32),
                             device=dev)
        g = torch.as_tensor(rng.standard_normal(B).astype(np.float32), device=dev)
        args = (fused, li, ncls, 0.5, tile, width, window)
        stats = c1.cbl_tile_fwd(*args)
        n_mask = int(stats[..., 6].sum())
        if ncls == 1 or k == 1:
            require(n_mask == 0, f"v1 C={c} ncls={ncls} K={k}: {n_mask} masked rows, not none")
        err = compare_tile_stats("cbl_tile_fwd", (args, {}, stats))
        bwd_args = (fused, li, stats, g) + args[2:]
        dfused = c1.cbl_tile_bwd(*bwd_args)
        require(dfused.shape == fused.shape, f"v1 gradient {tuple(dfused.shape)}")
        err = max(err, compare_tile_grad("cbl_tile_bwd", (bwd_args, {}, dfused)))
        plan = c1.launch_plan(B, m, k, ncls + c, ncls, tile)
        print(f"  cbl_tile C={c} ncls={ncls} M={m} K={k} ({n_mask} masked rows): fwd plan "
              f"{tuple(plan.pass1)}, scatter rows {plan.scatter_rows}: max|d| {err:.3g}, the same "
              f"bits twice, the feature gradient v2's bits", flush=True)


def check_plan_shapes(dev) -> None:
    """Phase 15: direct calls at the shapes whose plans take a smaller tile
    or slot chunks, against the plain versions: pt_attn_fwd and pt_attn_bwd
    at C = 512 with K = 8 (M = 1024) and K = 32 and 48 (M = 256) as in
    phase 11 (1e-4 of scale, the forward's bits twice, dkv exact on integer
    cotangents); cbl_stats_fwd on windows wider than shared memory holds
    (width 7 x tile 256 and width 3 x tile 1024, K = 36) as in phase 9
    (counts exact, sums rel 1e-5, the same bits twice), and its L2 path at
    the flagship's level-0 window equal bit for bit to the staged path;
    cbl_tile2_fwd and cbl_tile2_bwd at V2_SHAPES (C in {1, 20, 32, 33, 64,
    128}, K in {1, 35, 300}, M·K >= 2^23, tile x width 128 x 5 and 1024 x
    1, every row and no row in the loss mask) as in phase 14; and v1 at
    V1_SHAPES (C in {1, 32, 33, 128}, ncls in {1, 13, 40}, K in {1, 35}) as
    in phase 14."""
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for m, k, tile, width in ((1024, 8, 256, 3), (256, 32, 256, 1), (256, 48, 256, 1)):
            args, g = attn_inputs(dev, rng, 512, m, k, tile, width)
            fwd = (args, {}, pa.pt_attn_fwd(*args))
            bwd = (args + (g,), {}, pa.pt_attn_bwd(*args, g))
            err = max(compare_pt_attn_fwd(fwd), compare_pt_attn_bwd(bwd))
            check_pt_attn_bwd_exact(bwd)
            print(f"  pt_attn C=512 M={m} K={k}: fwd plan {tuple(pa.fwd_plan(B, m, k, 512))}, "
                  f"bwd plan {tuple(pa.bwd_plan(B, m, k, 512))}: max|d| {err:.3g}, dkv exact",
                  flush=True)
        labels = torch.as_tensor(rng.integers(0, NUM_CLASSES, (B, N)), device=dev)
        onehot = torch.nn.functional.one_hot(labels, NUM_CLASSES).float()
        onehot[torch.as_tensor(rng.random((B, N)) < 0.1, device=dev)] = 0.0
        meta = cd.row_meta(onehot)
        features = torch.as_tensor(rng.standard_normal((B, N, cd.CHANNELS), dtype=np.float32),
                                   device=dev)
        for k, tile, width, window in ((36, 256, 7, 3), (36, 1024, 3, 1), (35, 256, 3, 1)):
            w_sz = tile * width
            li = torch.as_tensor(rng.integers(0, w_sz + 1, (B, N, k)).astype(np.int32), device=dev)
            args = (features, meta, li, 1.0, tile, width, window)
            out = cd.cbl_stats_fwd(*args)
            err = compare_stats_fwd((args, {}, out))
            plan = cd.fwd_plan(B, N, k, tile, width)
            if plan[2]:  # a staged window: the L2 path gives its bits
                other = torch.empty_like(out)
                blocks, threads, _ = plan
                build.check(build.library().cbl_stats_fwd(
                    features.data_ptr(), meta.data_ptr(), li.data_ptr(), other.data_ptr(), B, N,
                    k, cd.CHANNELS, tile, width, window, cd._inv_t(1.0), blocks, threads, 0,
                    torch.cuda.current_stream(dev).cuda_stream), "cbl_stats_fwd")
                require(torch.equal(other.view(torch.int32), out.view(torch.int32)),
                        f"cbl_stats_fwd W={w_sz}: the L2 path's bits differ from the staged path's")
            print(f"  cbl_stats_fwd K={k} W={w_sz}: plan {plan}, max|d| {err:.3g}, the same bits "
                  f"twice{', and through L2' if plan[2] else ''}", flush=True)
        del features, meta, labels, onehot
        torch.cuda.empty_cache()
        check_v2_shapes(dev, rng)
        check_v1_shapes(dev, rng)


def check_routes(metrics: dict) -> None:
    """Phase 13: the CBL losses of one step on the same weights and batch
    on the dense and v2 routes against the XLA tile route's, each stage
    within the tolerance the CPU tests state for the pair."""
    for route, rtol in ROUTE_RTOL.items():
        rels = {k: abs(metrics[route][k] - metrics["xla"][k]) / abs(metrics["xla"][k])
                for k in ["cbl"] + [f"cbl_stage{i}" for i in range(STAGES)]}
        print(f"CBL losses, {route} route vs the XLA tile route: "
              + ", ".join(f"{k} {metrics[route][k]:.7f} vs {metrics['xla'][k]:.7f} "
                          f"(rel {v:.3g})" for k, v in rels.items()), flush=True)
        require(all(v <= rtol for v in rels.values()),
                f"the {route} route's CBL losses are not within rel {rtol} of the XLA route's")


def bare_entry(name, args, kw):
    """A kernel's C entry on operands prepared once, outside the timed call:
    none of the wrapper's host work (operand checks and conversions, the
    window starts copied to the card, the output allocated, the parameter
    gradients' and statistics' partial rows summed) is timed. The attention
    backward's dk|dv is not zeroed between runs. The returned call keeps
    its operands alive."""
    lib, stream = build.library(), torch.cuda.current_stream(args[0].device).cuda_stream

    def call(entry, tensors, *rest):
        ptrs = [t.data_ptr() for t in tensors]
        return lambda _keep=tensors: build.check(entry(*ptrs, *rest, stream), name)

    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        ns, tile = support.shape[1], kw["tile"]
        idx = torch.empty((b, m, k), dtype=torch.int32, device=query.device)
        val = torch.empty((b, m, k), dtype=torch.float32, device=query.device)
        return call(lib.cbl_win_topk, (query, support, idx, val), b, m, ns, k, tile,
                    kw["width"], kw["window"], ns // tile, wt.MODES[kw.get("mode", "plain")])
    if name == "window_gather":
        x, li, starts, tile, width = args
        b, ns, c = x.shape
        m, k = li.shape[1:]
        out = torch.empty((b, m, k, c), dtype=x.dtype, device=x.device)
        eb = x.element_size()
        plan = tg.gather_plan(b * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                              eb)
        ops = (x, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), out)
        return call(lib.cbl_window_gather, ops, b, ns, m, k, c, tile, width, plan.lpg, plan.nt,
                    plan.rw, eb)
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        b, m, k, c = g.shape
        dx = torch.empty((b, ns, c), dtype=g.dtype, device=g.device)
        ops = (g, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), dx)
        return call(lib.cbl_window_gather_bwd, ops, b, ns, m, k, c, tile, width, g.element_size())
    if name == "cbl_stats_fwd":
        features, meta, li, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        ops = (f, mt, lii, torch.empty((b, m, 8), dtype=torch.float32, device=f.device))
        return call(lib.cbl_stats_fwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), *cd.fwd_plan(b, m, k, tile, width))
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        q, kv, rel, li, starts, tile, width, params = args[:8]
        (q, kv, rel, li, st), ps, (b, m, k, c, cs_) = pa._cuda_args(
            q, kv, rel, li, starts, tile, width, params)
        ptrs = pa._pointers(ps)
        head = (q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p))
        if name == "pt_attn_fwd":
            plan = pa.fwd_plan(b, m, k, c)
            out = (torch.empty_like(q), torch.empty((plan.blocks, 2 * c + 2 * cs_), device=q.device))
            entry = lib.cbl_pt_attn_fwd
        else:  # g_out in q's dtype; dq and dk|dv float32 (the wrapper casts them after)
            plan = pa.bwd_plan(b, m, k, c)
            out = (args[8].to(q.dtype).contiguous(), torch.empty_like(q, dtype=torch.float32),
                   torch.zeros_like(kv, dtype=torch.float32),
                   torch.empty((plan.blocks, sum(pa._prow(c, cs_))), device=q.device))
            entry = lib.cbl_pt_attn_bwd
        ptr_args = head + tuple(t.data_ptr() for t in out)
        keep = (q, kv, rel, li, st, ps, ptrs, out)
        return lambda _keep=keep: build.check(entry(
            *ptr_args, b, m, k, c, tile, width, plan.blocks, plan.threads, plan.rows, plan.chunk,
            plan.smem, q.element_size(), stream), name)
    if name == "cbl_stats_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        coef = torch.empty((b, m, k), dtype=torch.float32, device=f.device)
        lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
        ops = (f, mt, lii, stats.contiguous(), g.contiguous(), coef, lands, torch.empty_like(f))
        return call(lib.cbl_stats_bwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), cd.bwd_plan(b, m, tile)[1])
    if name == "cbl_tile2_fwd":
        features, meta, li, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii = c2.v2_operands(features, meta, li, tile, width)
        plan = c2.fwd_plan(b, m, lii.shape[-1], c)
        ops = (f, mt, lii, torch.empty((b, m, 8), device=f.device))
        return call(lib.cbl_tile2_fwd, ops, b, m, lii.shape[-1], plan.channels, tile, width,
                    window, float(temperature), plan.label_rows, plan.row_rows)
    if name == "cbl_tile2_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii, st, gl = c2.v2_operands(features, meta, li, tile, width, stats, g)
        k = lii.shape[-1]
        plan = c2.bwd_plan(b, m, k, c, tile)
        scratch = (torch.empty((b, m, k), device=f.device),
                   torch.empty((b, m, k), dtype=torch.int32, device=f.device), torch.empty_like(f))
        return call(lib.cbl_tile2_bwd, (f, mt, lii, st, gl) + scratch, b, m, k,
                    plan.pass1.channels, tile, width, window, float(temperature),
                    plan.pass1.row_rows, plan.scatter_rows)
    if name in ("cbl_tile_fwd", "cbl_tile_bwd"):
        fused, li = args[:2]
        ncls = args[2] if name == "cbl_tile_fwd" else args[4]
        temperature, tile, width, window = args[-4:]
        b, m, columns = fused.shape
        k = li.shape[-1]
        plan = c1.launch_plan(b, m, k, columns, ncls, tile)
        empty = lambda *shape: torch.empty(shape, device=fused.device)
        split = (empty(b, m, plan.pass1.channels), empty(b, m, 8))  # features, meta
        dims = (b, m, k, columns - ncls, ncls, tile, width, window, float(temperature))
        lii = li.to(torch.int32).contiguous()
        if name == "cbl_tile_fwd":
            return call(lib.cbl_tile_fwd, (fused, lii) + split + (empty(b, m, 8),), *dims,
                        plan.pass1.label_rows, plan.pass1.row_rows)
        scratch = split + (empty(b, m, k), torch.empty((b, m, k), dtype=torch.int32,
                                                       device=fused.device),
                           empty(b, m, plan.pass1.channels), torch.empty_like(fused))
        return call(lib.cbl_tile_bwd, (fused, lii, args[2].contiguous(), args[3].contiguous())
                    + scratch, *dims, plan.pass1.row_rows, plan.scatter_rows)
    raise ValueError(f"no bare entry for {name}")


@torch.no_grad()
def time_spread(calls, dev, names, reps=20):
    """The spread of one launch's time: the largest recorded call of each
    kernel (level 0; window_topk by rows times k) timed reps times alone,
    each after an L2 flush, through its wrapper and through its bare C
    entry; for the dense and the v2 CBL backward, how their scatter's terms
    (slots with a coefficient != 0) spread over the support tiles, one
    block's work each at level 0."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name in names:
        args, kw, _ = max(calls[name], key=lambda call: call[0][0].numel() * (
            call[0][2] if name == "window_topk" else 1))
        mod, attr, _ = WRAPPERS[name]
        for what, fn in (("wrapper", lambda: getattr(mod, attr)(*args, **kw)),
                         ("bare C entry", bare_entry(name, args, kw))):
            ts = sorted(time_ms(fn, flush_buf, reps=1) for _ in range(reps))
            print(f"  {name} {tuple(args[0].shape)} {kw}, {what}, {reps} runs: min {ts[0]:.4f} ms, median "
                  f"{statistics.median(ts):.4f} ms, max {ts[-1]:.4f} ms", flush=True)
        if name == "cbl_stats_bwd":
            features, meta, li, _, _, _, tile, width, window = args
            m = features.shape[1]
            starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=dev)
            rows, member = tg._rows(li, starts, tile, width, m)
            hit = member & (cd.cbl_bwd_cd_plain(*args)[0] != 0)
            per_tile = torch.bincount(rows[hit] // tile, minlength=features.shape[0] * m // tile)
            print(f"  {name} {tuple(features.shape)}: {int(hit.sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)
        if name == "cbl_tile2_bwd":
            features, meta, li, stats, g, temperature, tile, width, window = args
            coef, rows = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats,
                                             g, temperature, tile, width, window)
            per_tile = torch.bincount(rows[coef != 0] // tile,
                                      minlength=features.shape[0] * features.shape[1] // tile)
            print(f"  {name} {tuple(features.shape)}: {int((coef != 0).sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)


def check_cbl_kernels(dev, pallas) -> list:
    """Phase 14: every v2 call of the recorded cbl-pallas step against its
    plain version and timed; v1 at that step's level-0 shape ([its soft
    labels | its latents], K = 35) against its plain version, as v2 is
    held, and against v2 on the same inputs, timed, and 20 times alone; gather_rows exact on x [131072, 128] f32 with
    131072 random rows, torch.index_select timed beside it. The launches
    of v1 and gather_rows are those of the cbl-pallas step (0: no path runs
    them); their direct calls here are counted apart."""
    names = ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
    max_err = {name: 0.0 for name in names}
    summary = time_calls(pallas["calls"], dev, pallas["launches"], max_err, names[:2], reps=5)
    time_spread(pallas["calls"], dev, names[:2])

    features, label_soft, li, temperature, tile, width, window = pallas["stage_inputs"][0]
    ncls = label_soft.shape[-1]
    fused = torch.cat([label_soft, features], -1).contiguous()
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(B), dtype=torch.float32,
                        device=dev)
    reset_counts()
    stats1 = c1.cbl_tile_fwd(fused, li, ncls, temperature, tile, width, window)
    dfused = c1.cbl_tile_bwd(fused, li, stats1, g, ncls, temperature, tile, width, window)
    torch.cuda.synchronize()
    direct = read_counts()
    meta = cd.row_meta(label_soft)
    stats2 = c2.cbl_tile2_fwd(features, meta, li, temperature, tile, width, window)
    dx2 = c2.cbl_tile2_bwd(features, meta, li, stats2, g, temperature, tile, width, window)
    sums1, sums2 = stats1[..., 5].sum(-1), stats2[..., 5].sum(-1)
    rel = float(((sums1 - sums2).abs() / sums2.abs()).max())
    print(f"  v1 vs v2 kernels at {tuple(fused.shape)}, K={li.shape[-1]}: loss sums "
          f"{sums1.tolist()} vs {sums2.tolist()} (rel {rel:.3g})", flush=True)
    require(torch.equal(stats1[..., [3, 4, 6]], stats2[..., [3, 4, 6]]), "v1 and v2 counts differ")
    require(rel <= 1e-5, "v1 and v2 loss sums differ")
    compare_scaled("v1 vs v2 feature gradient", dfused[..., ncls:], dx2, 1e-4)
    v1_calls = {
        "cbl_tile_fwd": [((fused, li, ncls, temperature, tile, width, window), {}, stats1)],
        "cbl_tile_bwd": [((fused, li, stats1, g, ncls, temperature, tile, width, window), {},
                          dfused)],
    }
    summary += time_calls(v1_calls, dev, pallas["no_path"], max_err, names[2:4], reps=5)
    time_spread(v1_calls, dev, names[2:4])

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((131072, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 131072, 131072, dtype=np.int32), device=dev)
    reset_counts()
    out = gd.gather_rows(x, idx)
    direct["gather_rows"] = read_counts()["gather_rows"]
    require(torch.equal(out, x[idx.long()]), "gather_rows differs from x[idx]")
    print(f"  gather_rows {tuple(out.shape)}: equal to x[idx]", flush=True)
    summary += time_calls({"gather_rows": [((x, idx), {}, out)]}, dev, pallas["no_path"],
                          max_err, names[4:])
    for entry in summary[2:]:  # no path runs them: launches made here
        entry["direct_launches"] = direct[entry["name"]]
    return summary


def require_bf16_counts(by_dtype: dict, expect: dict, what: str) -> None:
    """The launches of each kernel in ``expect`` by dtype, exactly."""
    for name, want in expect.items():
        got = {k: by_dtype[name][k] for k in want}
        require(got == want, f"{name} in {what}: launches by dtype {got}, not {want}")


def bf16_calls_on_host(calls: dict, names) -> dict:
    """The bfloat16 calls of ``names`` among a step's recorded calls, moved
    to host memory: the later phases' peak memory does not count them."""
    return frozen({name: split_bf16(calls)[name] for name in names}, torch.device("cpu"))


def check_bf16_kernels(dev, host_calls, launches) -> list:
    """Phase 19: the bfloat16 calls of the recorded bf16 steps (the gathers
    of phase 17's, the attention of phase 18's; kept in host memory until
    now) against the plain versions and timed as in phase 4; the bounds from
    the bfloat16 bytes."""
    calls = frozen(host_calls, dev)
    names = tuple(BF16_KERNELS)
    for name in names:
        require(len(calls[name]) == launches[name], f"{name}: {len(calls[name])} recorded calls, "
                f"{launches[name]} launches")
    with torch.no_grad():
        for c in calls["pt_attn_bwd_bf16"]:
            check_pt_attn_bwd_exact(c)
    max_err = {name: 0.0 for name in names}
    records = []
    summary = time_calls(calls, dev, launches, max_err, names, reps=5, records=records)
    print_widths([r for r in records if r[0].startswith("pt_attn")])
    time_against_f32(calls, dev, names)
    return summary


def as_f32(call):
    """A bfloat16 call's float32 twin: its bfloat16 operands (x, g, q, kv,
    g_out) widened exactly, the backward's dx dtype float32."""
    args, kw, _ = call
    widen = lambda t: t.float() if isinstance(t, torch.Tensor) and t.dtype == BF16 else t
    return tuple(widen(a) for a in args), {k: torch.float32 if v is BF16 else v
                                           for k, v in kw.items()}


@torch.no_grad()
def time_against_f32(calls, dev, names, reps=5) -> None:
    """Each bfloat16 call and its float32 twin through the same wrapper,
    timed in turns (f32, bf16, bf16, f32; L2 flushed, mean of ``reps``
    each), summed over the calls: what the element type alone changes."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name in names:
        mod, attr, _ = WRAPPERS[base(name)]
        fn = getattr(mod, attr)
        tot = {"f32": 0.0, "bf16": 0.0}
        for call in calls[name]:
            args, kw = call[0], call[1]
            args32, kw32 = as_f32(call)
            for what, a, k in (("f32", args32, kw32), ("bf16", args, kw), ("bf16", args, kw),
                               ("f32", args32, kw32)):
                tot[what] += time_ms(lambda: fn(*a, **k), flush_buf, reps) / 2
        print(f"  {name} on the same {len(calls[name])} calls in turns: bfloat16 {tot['bf16']:.4f} "
              f"ms, float32 {tot['f32']:.4f} ms ({tot['bf16'] / tot['f32']:.3f}x)", flush=True)


def serve(dev, batch, bn_mode="batch", ref_probs=None, dtype=torch.float32) -> dict:
    """Phases 3, 7, 16 and 18: the checkpoint served with flax batch BN or
    stale BN, float32 or bfloat16, on one B x N batch: one request with the
    launch counts reset just before and read just after (each kernel of the
    path > 0) and its calls recorded, the running statistics untouched,
    three timed requests, probs against the plain versions' (and against
    ``ref_probs`` where given: eval-mode BN is the same function in both
    modes), crop OA. A bfloat16 model's ``ref_probs`` are the float32
    model's on the same weights: their gap is the scale, and the kernels'
    probs are held within half of it of the plain versions' (argmax agreeing
    on >= 99.5% of points)."""
    kernels = SERVE_KERNELS if bn_mode == "batch" else STALE_SERVE_KERNELS
    bf16 = dtype == BF16
    model, trained = load_model(bn_mode, dtype)
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES)

    def predict(bt):
        probs, _ = step(bt)
        return probs.cpu().numpy()

    before = buffers(model)
    predict(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with recording() as calls:
        probs, conf = step(batch)
        torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in kernels}
    by_dtype = read_dtype_counts()
    print(f"launches in one request ({bn_mode} BN{', bfloat16' if bf16 else ''}): {launches}, "
          f"by dtype {by_dtype}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(bool(torch.isfinite(probs).all()) and probs.shape == (B, N, NUM_CLASSES),
            f"probs {tuple(probs.shape)} not finite")
    require(all(torch.equal(v, before[k]) for k, v in buffers(model).items()),
            "a request changed the running statistics")

    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict(batch)
        lat.append(time.perf_counter() - t0)
    med, peak = statistics.median(lat), torch.cuda.max_memory_allocated()
    print(f"request latency ({bn_mode} BN{', bfloat16' if bf16 else ''}) median {med * 1e3:.3f} "
          f"ms over {[round(x * 1e3, 3) for x in lat]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)

    with plain_kernels():
        p_plain, _ = step(batch)
    if bf16:
        require(ref_probs is not None, "a bfloat16 request needs the float32 model's probs")
        gap = float((probs - ref_probs).abs().max())
        agree32 = float((probs.argmax(-1) == ref_probs.argmax(-1)).float().mean())
        d = float((probs - p_plain).abs().max())
        agree = float((probs.argmax(-1) == p_plain.argmax(-1)).float().mean())
        print(f"kernels vs plain versions (bfloat16): max|dprobs| {d:.3g}, argmax agreement "
              f"{agree:.6f}; bfloat16 vs float32 model, same weights: max|dprobs| {gap:.3g}, "
              f"argmax agreement {agree32:.6f}", flush=True)
        require(d <= 0.5 * gap and agree >= 0.995, "bfloat16 probs disagree with the plain versions")
        refs = {}
    else:
        refs = {"plain versions": p_plain}
        if ref_probs is not None:
            refs["batch-BN model"] = ref_probs
    for what, ref in refs.items():
        d = float((probs - ref).abs().max())
        agree = float((probs.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"kernels vs {what}: max|dprobs| {d:.3g}, argmax agreement {agree:.6f}", flush=True)
        require(d <= 1e-3 and agree >= 0.999, f"probs disagree with the {what}")
    conf = conf.cpu().numpy()
    oa = float(np.trace(conf) / conf.sum())
    print(f"crop OA {oa:.4f} ({'trained' if trained else 'random'} weights)", flush=True)
    if trained:
        require(oa >= 0.5, f"crop OA {oa:.4f} < 0.5")
    return dict(step=step, predict=predict, calls=calls, launches=launches, probs=probs, med=med,
                peak=peak, by_dtype=by_dtype)


def voting(predict, what="request", steps=3) -> None:
    """Phase 6: VotingEvaluator over room 0 for ``steps`` requests."""
    ev = VotingEvaluator(room0(), predict, NUM_CLASSES, N, batch_size=B,
                         voxel_size=0.04, num_votes=20, seed=0)
    t0 = time.perf_counter()
    m = ev.run(max_steps=steps)
    per = (time.perf_counter() - t0) / steps
    print(f"voting: {per * 1e3:.3f} ms per {what} over {steps} requests "
          f"(sub mIoU so far {m['sub']['mIoU']:.4f})", flush=True)


def eval_features(dev, batch, served: dict, bn_mode="batch", dtype=torch.float32,
                  f32_feats=None) -> dict:
    """Phases 20 and 23: make_eval_step(output='logits', with_features=True)
    on the checkpoint and phase serve's batch (``served``: the probs and
    launches of phase serve, or of phase stale-serve under stale BN, or of
    the bfloat16 requests of phases bf16-serve and bf16-stale): one request
    with the counts reset just before and read just after (as the served
    request's), softmax(logits) within 1e-6 of the served probs (bfloat16:
    max |d| 0) with the same argmax, each latent [B, N, d] finite in the
    caller's row order; float32: the logits and every latent within 1e-3 of
    their scale of the plain versions'; bfloat16: the RMS of every latent's
    difference from the plain versions' within half of the RMS of the
    bfloat16-vs-float32 gap (``f32_feats``: the float32 model's latents on
    the same weights and batch, the gap's other side), or within twice the
    floor that sum order alone sets: the RMS of the plain versions' latents
    against the same with the fused attention's slots reversed
    (``reversed_slots``: the same function, its sums over the slots in
    another order). The RMS, as the CPU tests of the stale bfloat16 model
    take it: under stale BN the fused attention sums in another order than
    its plain version, an output at a bfloat16 rounding boundary rounds one
    ulp apart, and 18 layers spread the flips, so single latent elements can
    differ by as much as the gap's largest element (latent2 of the stale
    model on the H100: 0.0315 against 0.0315) and latent1's RMS reached
    0.53 of the gap's. Returns the model, the launches and the latents on
    the host."""
    bf16 = dtype == BF16
    model, _ = load_model(bn_mode, dtype)
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES,
                          output="logits", with_features=True)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, _, feats = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in read_counts().items() if k in served["launches"]}
    what = f"{bn_mode} BN" + (", bfloat16" if bf16 else "")
    by_dtype = read_dtype_counts()
    print(f"feature request ({what}): launches {launches}, by dtype {by_dtype}, {ms:.3f} ms on "
          f"the host clock", flush=True)
    require(launches == served["launches"],
            f"launches {launches} differ from the served request's {served['launches']}")
    if bf16:
        require(by_dtype == served["by_dtype"],
                f"launches by dtype {by_dtype} differ from the served request's")
    probs = torch.softmax(logits, -1)
    d = float((probs - served["probs"]).abs().max())
    print(f"softmax(logits) vs the served probs: max|d| {d:.3g}", flush=True)
    require(d == 0 if bf16 else d <= 1e-6, "softmax(logits) differs from the served probs")
    require(torch.equal(probs.argmax(-1), served["probs"].argmax(-1)),
            "softmax(logits) and the served probs disagree on an argmax")
    require(logits.shape == (B, N, NUM_CLASSES), f"logits {tuple(logits.shape)}")
    for k, v in feats.items():
        require(v.shape[:2] == (B, N) and bool(torch.isfinite(v).all()),
                f"{k} {tuple(v.shape)} not finite")
    with plain_kernels():
        p_logits, _, p_feats = step(batch)
    require(sorted(feats) == sorted(p_feats), "the plain step gave other latents")
    host = {k: v.cpu() for k, v in feats.items()}
    if bf16:
        require(sorted(host) == sorted(f32_feats), "the float32 model gave other latents")
        floor_feats = {}
        if "pt_attn_fwd" in launches:
            with plain_kernels(), mock.patch.object(pa, "pt_attn_fwd", reversed_slots):
                _, _, floor_feats = step(batch)
        errs = {}
        rms = lambda d: float(d.double().square().mean().sqrt())
        for k in sorted(host):
            d, g = host[k] - p_feats[k].cpu(), host[k] - f32_feats[k]
            err, gap = rms(d), rms(g)
            floor = rms(p_feats[k].cpu() - floor_feats[k].cpu()) if floor_feats else 0.0
            print(f"  {k} {tuple(host[k].shape)}: kernels vs plain RMS {err:.3g} (max|d| "
                  f"{float(d.abs().max()):.3g}), {err / gap:.3f} of the bfloat16 vs float32 "
                  f"model's RMS {gap:.3g} (max|d| {float(g.abs().max()):.3g}); the plain "
                  f"version against itself with the attention's slots reversed RMS {floor:.3g}",
                  flush=True)
            require(err <= max(0.5 * gap, 2.0 * floor),
                    f"{k}: kernels vs plain RMS {err:.3g} > half the gap's {gap:.3g} and > twice "
                    f"the slot-order floor {floor:.3g}")
            errs[k] = err
    else:
        errs = {"logits": compare_scaled("logits", logits, p_logits, 1e-3)}
        for k in sorted(feats):
            errs[k] = compare_scaled(k, feats[k], p_feats[k], 1e-3)
    print(f"latents {', '.join(f'{k} {tuple(v.shape)}' for k, v in sorted(feats.items()))}; "
          f"kernels vs plain versions max|d|: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}", flush=True)
    return dict(model=model, launches=launches, feats=host)


def reversed_slots(q, kv, rel, li, starts, tile, width, params):
    """pt_attn_plain with every row's K slots in reverse order: the same
    function (a softmax and a sum over the slots), its float32 sums over the
    slots taken in another order."""
    rev = torch.arange(li.shape[2] - 1, -1, -1, device=li.device)
    return pa.pt_attn_plain(q, kv, rel[:, :, rev], li[:, :, rev], starts, tile, width, params)


def voting_features(dev, model, max_steps=40) -> None:
    """Phase 21: run_voting_eval over room 0 with the feature step
    (num_votes 1.0, at most ``max_steps`` requests), then run_boundary_suite
    with 'boundary-stat-feature' on the voted cloud: B-IoU finite in [0, 1],
    every latent's l2, cos and norml2 distances finite."""
    ctx = {}
    t0 = time.perf_counter()
    m = run_voting_eval(model, PyramidSpec(), room0(), num_classes=NUM_CLASSES, n_points=N,
                        batch_size=B, voxel_size=0.04, num_votes=1.0, extra_ops="feature",
                        max_steps=max_steps, device=dev, ctx=ctx, log=lambda *_: None)
    t_vote = time.perf_counter() - t0
    ev = ctx["evaluator"]
    cs = ev.clouds[0]
    print(f"voting with features: {ev.requests} requests in {t_vote:.3f} s "
          f"({t_vote / ev.requests * 1e3:.3f} ms a request), {len(cs.coord)} points, final "
          f"min potential {cs.min_potential():.4f}, sub mIoU {m['sub']['mIoU']:.4f} OA "
          f"{m['sub']['OA']:.4f}, full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}",
          flush=True)
    require(len(cs.features) == len(model.planes), f"latents {sorted(cs.features)}")
    t0 = time.perf_counter()
    clouds = [{"coord": c.coord, "label": c.label, "prob": c.probs, "features": c.features}
              for c in ev.clouds]
    bm = run_boundary_suite(clouds, NUM_CLASSES, 0.1, "boundary-stat-feature",
                            log=lambda *_: None)
    br, st = bm["boundary"], bm["stat"]
    b_iou = br["B-IoU"]
    print(f"boundary suite in {time.perf_counter() - t0:.3f} s: B-IoU {b_iou:.4f}, "
          f"pct_err_on_bound_label {st['pct_err_on_bound_label']:.4f}", flush=True)
    require(np.isfinite(b_iou) and 0 <= b_iou <= 1, f"B-IoU {b_iou}")
    for k in sorted(cs.features):
        for kind in ("l2", "cos", "norml2"):
            d = br[f"dist_{k}:{kind}"]
            require(bool(np.isfinite(list(d.values())).all()), f"dist_{k}:{kind} {d}")
        d = br[f"dist_{k}:l2"]
        print(f"  dist_{k}:l2 pos {d['pos']:.4f} neg {d['neg']:.4f} bound "
              f"{d['bound_mean']:.4f} plain {d['plain_mean']:.4f}", flush=True)


def enumerate_room(dev, model, trained: bool) -> None:
    """Phase 22: run_enumerate_eval over room 0 (n_points N, voxel_max
    80000, B crops a request, 'boundary-stat'): every point covered, full OA
    >= 0.5 with the trained checkpoint; the eval step's time per request on
    the host clock and the room's seconds split into the eval step (launches
    and device, to a synchronize) and the rest (host numpy and copies)."""
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES,
                          output="logits")
    step_s = []

    def timed(bt):
        t0 = time.perf_counter()
        out = step(bt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    ctx = {"eval_step": timed}
    t0 = time.perf_counter()
    m = run_enumerate_eval(model, PyramidSpec(), room0(), num_classes=NUM_CLASSES, n_points=N,
                           voxel_size=0.04, voxel_max=80000, batch_size=B,
                           extra_ops="boundary-stat", device=dev, ctx=ctx, log=lambda *_: None)
    total = time.perf_counter() - t0
    ev = ctx["evaluator"]
    counts = ev.pred_counts[0]
    oa = m["full"]["OA"]
    print(f"enumerate: {ev.passes[0]} passes, {ev.parts[0]} parts, {ev.requests} requests, "
          f"{len(counts)} points (each predicted {int(counts.min())}-{int(counts.max())} times); "
          f"eval step {statistics.median(step_s) * 1e3:.3f} ms a request (median on the host "
          f"clock); room {total:.3f} s = eval step {sum(step_s):.3f} s + host "
          f"{total - sum(step_s):.3f} s; full mIoU {m['full']['mIoU']:.4f} OA {oa:.4f} mACC "
          f"{m['full']['mACC']:.4f}; B-IoU {m['boundary']['B-IoU']:.4f}, pct_err_on_bound_label "
          f"{m['stat']['pct_err_on_bound_label']:.4f}", flush=True)
    require(bool((counts > 0).all()), "enumeration missed points")
    if trained:
        require(oa >= 0.5, f"enumerate full OA {oa:.4f} < 0.5")


def write_s3dis_rooms(root: Path) -> None:
    """Phase 24's dataset: ENTRY_ROOMS synthetic train rooms (Area_1_*) and
    one val room (Area_5_*) of ENTRY_POINTS points each, as S3DIS xyzrgbl
    .npy files."""
    for split, area, n in (("train", 1, ENTRY_ROOMS), ("val", 5, 1)):
        rooms = SyntheticSceneDataset(num_rooms=n, points_per_room=ENTRY_POINTS, seed=0,
                                      split=split)
        for i in range(n):
            c, f, lab = rooms.room(i)
            np.save(root / f"Area_{area}_room{i}.npy",
                    np.concatenate([c, f, lab[:, None]], 1).astype(np.float32))


def count_delta(after, before):
    """Launch counts (or nested counts by dtype) of ``after`` less ``before``."""
    if isinstance(after, dict):
        return {k: count_delta(v, before[k]) for k, v in after.items()}
    return after - before


class StepProbe:
    """Phases 24-25's instrumentation of the entry's train loop: ``prefetch``
    replaces main.py's prefetch (the real one, or with ``use_prefetch`` off
    the bare iterator in the loop's thread) and wraps its iterator in a
    utils/profiling.py::StepTimer: the wait for each batch, then the step
    ended by a synchronize, and the kernels each step launched (counts and
    counts by dtype, read before and after; the loop's own counts are
    never reset). ``peak``: max_memory_allocated at the end of the loop,
    before the epoch-end eval."""

    def __init__(self, use_prefetch: bool = True):
        self.use_prefetch = use_prefetch
        self.waits, self.steps, self.launches, self.by_dtype = [], [], [], []
        self.timer, self.peak = None, None

    def prefetch(self, factory, depth=2):
        it = entry_prefetch(factory, depth) if self.use_prefetch else factory()
        self.timer = StepTimer()
        t_end = time.perf_counter()
        for item in it:
            self.timer.data_ready()
            t_ready = time.perf_counter()
            self.waits.append(t_ready - t_end)
            counts, by_dtype = read_counts(), read_dtype_counts()
            yield item
            torch.cuda.synchronize()
            self.timer.step_done()
            t_end = time.perf_counter()
            self.steps.append(t_end - t_ready)
            self.launches.append(count_delta(read_counts(), counts))
            self.by_dtype.append(count_delta(read_dtype_counts(), by_dtype))
        self.peak = torch.cuda.max_memory_allocated()


def run_entry(argv, probe=None):
    """main.py's main(argv) with main.py's prefetch replaced by ``probe``'s
    (where given) and its setup recorded → (main's result, the setups'
    results, seconds, the launch counts of the whole run from 0)."""
    built = []

    def setup(*args, **kw):
        out = entry_setup(*args, **kw)
        built.append(out)
        return out

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(entry, "setup", setup))
        if probe is not None:
            stack.enter_context(mock.patch.object(entry, "prefetch", probe.prefetch))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = entry.main(argv)
        torch.cuda.synchronize()
        return out, built, time.perf_counter() - t0, read_counts()


def entry_losses(exp: Path) -> list:
    """The train losses main.py recorded, read with the port's read_scalars."""
    series = read_scalars(str(exp / "scalars.jsonl"))
    return series["train/loss"]


def print_probe(what: str, probe: StepProbe) -> float:
    med = statistics.median(probe.steps)
    print(f"{what}: {len(probe.steps)} steps, the wait for each batch "
          f"{[round(x * 1e3, 3) for x in probe.waits]} ms (median "
          f"{statistics.median(probe.waits) * 1e3:.3f}), step {[round(x * 1e3, 3) for x in probe.steps]}"
          f" ms (median {med * 1e3:.3f}), StepTimer {probe.timer.summary()}, "
          f"{B * N / med:.1f} points/s at the median, max_memory_allocated {probe.peak} B",
          flush=True)
    return med


def train_entry(dev, root: Path, batch, train_launches: dict) -> None:
    """Phase 24: the flagship trained through main.py from S3DIS .npy rooms,
    its snapshot read back by --mode val."""
    exp, exp_plain = root / "exp", root / "exp_no_prefetch"
    data = f"data.data_root:{root / 'data'}"
    print(f"main.py -c s3dis_pt_cbl --mode train --set {data};{ENTRY_SETS};{ENTRY_LOG}: full "
          f"width and depth from the flax-like init, default_train_transform, prefetch depth 3; "
          f"cuts: batch 16 -> 2, epochs 200 -> 1 (loop 30 -> 2: {ENTRY_ROOMS} rooms x 2 = "
          f"{ENTRY_ROOMS} steps of 2); log_freq 10 -> 1 reads every step's loss", flush=True)
    probe = StepProbe()
    best, built, secs, total = run_entry(
        ["-c", "s3dis_pt_cbl", "--mode", "train", "--set", f"{data};{ENTRY_SETS};{ENTRY_LOG}",
         "--exp_dir", str(exp)], probe)
    (model, _, _, opt, *_), = built
    med = print_probe("train-entry (prefetch)", probe)
    print(f"the whole run {secs:.3f} s (setup, {len(probe.steps)} steps, the epoch-end voting "
          f"eval, the snapshot); best full-cloud mIoU {best:.4f}; launches of the run {total}",
          flush=True)
    steps, losses = entry_losses(exp)
    print(f"losses {losses} at steps {steps}", flush=True)
    require(steps == list(range(1, ENTRY_ROOMS + 1)) and all(np.isfinite(losses)),
            f"losses {losses} at steps {steps}")
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    for i, launches in enumerate(probe.launches):
        got = {k: launches[k] for k in TRAIN_KERNELS}
        require(got == train_launches, f"step {i}: launches {got}, phase train's {train_launches}")
    print(f"launches a step (each of the {len(probe.launches)}): "
          f"{ {k: probe.launches[0][k] for k in TRAIN_KERNELS} }, equal to phase train's",
          flush=True)
    snap, marker = exp / "checkpoints" / f"snap-{ENTRY_ROOMS}", exp / "checkpoints" / "best.json"
    require(snap.exists() and marker.exists(), "no snapshot or best.json")
    print(f"{snap.name}: {snap.stat().st_size} B; best.json {marker.read_text()}", flush=True)

    plain = StepProbe(use_prefetch=False)
    run_entry(["-c", "s3dis_pt_cbl", "--mode", "train", "--set",
               f"{data};{ENTRY_SETS};{ENTRY_LOG};eval.num_votes:0", "--exp_dir", str(exp_plain)],
              plain)
    med_plain = print_probe("train-entry (the iterator in the loop's thread, no eval request)",
                            plain)
    print(f"step median with prefetch {med * 1e3:.3f} ms, without {med_plain * 1e3:.3f} ms; "
          f"the wait a step (median) {statistics.median(probe.waits) * 1e3:.3f} against "
          f"{statistics.median(plain.waits) * 1e3:.3f} ms", flush=True)

    m, built, secs, _ = run_entry(
        ["-c", "s3dis_pt_cbl", "--mode", "val", "--model_path", "auto", "--extra_ops", "",
         "--set", f"{data};{ENTRY_SETS}", "--exp_dir", str(exp)])
    (restored, _, _, r_opt, *_), = built
    live, back = model.state_dict(), restored.state_dict()
    require(live.keys() == back.keys() and all(torch.equal(live[k], back[k]) for k in live),
            "the restored parameters or buffers differ from the saved ones")
    o_live, o_back = opt.state_dict()["state"], r_opt.state_dict()["state"]
    require(o_live.keys() == o_back.keys() and all(
        torch.equal(o_live[i]["momentum_buffer"], o_back[i]["momentum_buffer"]) for i in o_live),
        "the restored optimizer state differs from the saved one")
    p_live = make_eval_step(model, PyramidSpec(), device=dev)(batch)[0]
    p_back = make_eval_step(restored, PyramidSpec(), device=dev)(batch)[0]
    d = float((p_live - p_back).abs().max())
    print(f"--mode val: {secs:.3f} s, restored {len(back)} tensors and {len(o_back)} momentum "
          f"buffers bit for bit; full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}; "
          f"probs of the restored vs the live model on one batch max|d| {d:.3g}", flush=True)
    require(d <= 1e-6, "the restored model's probs differ from the live model's")


def train_entry_bf16(root: Path) -> None:
    """Phase 25: two steps of s3dis_pt_cbl_bf16 through main.py, no eval
    request: losses finite, the gathers' launches by dtype phase
    bf16-train's."""
    data = f"data.data_root:{root / 'data'}"
    probe = StepProbe()
    _, _, secs, total = run_entry(
        ["-c", "s3dis_pt_cbl_bf16", "--mode", "train", "--set",
         f"{data};{ENTRY_SETS};{ENTRY_LOG};data.loop:1;eval.num_votes:0", "--exp_dir",
         str(root / "exp_bf16")], probe)
    print_probe("train-entry-bf16", probe)
    steps, losses = entry_losses(root / "exp_bf16")
    print(f"{secs:.3f} s; losses {losses} at steps {steps}; launches by dtype a step "
          f"{probe.by_dtype}", flush=True)
    require(len(steps) == 2 and all(np.isfinite(losses)), f"losses {losses}")
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    for by_dtype in probe.by_dtype:
        require_bf16_counts(by_dtype, BF16_STEP_GATHERS, "a bfloat16 step of main.py")


class RequestProbe:
    """Phase 26's instrumentation of main.py's test mode: ``make_eval_step``
    replaces main.py's and wraps the step it builds: each request ended by a
    synchronize, its seconds and the launches it made; on the first request
    also the probs of the plain versions on the same weights and batch."""

    def __init__(self):
        self.launches, self.seconds, self.probs = [], [], None

    def make_eval_step(self, *args, **kw):
        step = entry_eval_step(*args, **kw)

        def probe(batch):
            counts = read_counts()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.launches.append(count_delta(read_counts(), counts))
            if self.probs is None:
                with plain_kernels():
                    self.probs = (out[0].clone(), step(batch)[0])
            return out
        return probe


def prepare_test(root: Path, serve_launches: dict, train_launches: dict) -> None:
    """Phase 26: ScanNet's offline path through main.py: raw scenes written,
    prepared, calibrated, trained on and served."""
    raw, data, exp = root / "scannet_raw", root / "scannet", root / "exp_scannet"
    t0 = time.perf_counter()
    for i in range(SCANNET_SCENES):
        write_scannet_scene(str(raw), f"scene{i:04d}_00", np.random.default_rng(i))
    t1 = time.perf_counter()
    converted = prepare_scannet(str(raw), str(data), verbose=False)
    points = {Path(f).stem: len(np.load(f, mmap_mode="r")) for f in converted}
    print(f"wrote {SCANNET_SCENES} raw scenes in {t1 - t0:.3f} s; prepare_scannet "
          f"{time.perf_counter() - t1:.3f} s: points a scene {points}", flush=True)
    require(len(points) == SCANNET_SCENES, f"prepared {sorted(points)}")
    sets = f"data.data_root:{data};{SCANNET_SETS}"

    n_points, _, secs, _ = run_entry(["-c", "scannet_pt_cbl", "--mode", "calibrate", "--set",
                                      sets, "--exp_dir", str(exp)])
    print(f"--mode calibrate: {secs:.3f} s, data.n_points={n_points} (the preset's 65536)",
          flush=True)

    probe = StepProbe()
    _, _, secs, total = run_entry(
        ["-c", "scannet_pt_cbl", "--mode", "train", "--set",
         f"{sets};eval.num_votes:0;{ENTRY_LOG}", "--exp_dir", str(exp)], probe)
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    print_probe("prepare-test train (scannet_pt_cbl, 20 classes)", probe)
    steps, losses = entry_losses(exp)
    print(f"--mode train: {secs:.3f} s; losses {losses} at steps {steps}", flush=True)
    require(len(steps) == len(probe.steps) > 0 and all(np.isfinite(losses)), f"losses {losses}")
    for i, launches in enumerate(probe.launches):
        got = {k: launches[k] for k in TRAIN_KERNELS}
        require(got == train_launches, f"step {i}: launches {got}, phase train's {train_launches}")

    req = RequestProbe()
    with mock.patch.object(entry, "make_eval_step", req.make_eval_step):
        out, _, secs, _ = run_entry(
            ["-c", "scannet_pt_cbl", "--mode", "test", "--model_path", "auto", "--set", sets,
             "--exp_dir", str(exp), "--out_dir", str(root / "scannet_pred")])
    per = [{k: launches[k] for k in serve_launches} for launches in req.launches]
    probs, plain = req.probs
    print(f"--mode test (the preset's votes): {secs:.3f} s, {len(req.seconds)} requests of "
          f"{tuple(probs.shape)}, request median {statistics.median(req.seconds) * 1e3:.3f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches a request "
          f"{per[0]}", flush=True)
    require(all(p == serve_launches for p in per),
            f"launches a request {per}, phase serve's {serve_launches}")
    d = float((probs - plain).abs().max())
    agree = float((probs.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"first request, kernels vs plain versions: max|dprobs| {d:.3g}, argmax agreement "
          f"{agree:.6f}", flush=True)
    require(d <= 1e-3 and agree >= 0.999, "test-request probs disagree with the plain versions")
    for name, n in points.items():
        pred = np.load(Path(out) / f"{name}_pred.npy")
        print(f"{name}_pred.npy: {len(pred)} predictions for {n} prepared points, classes "
              f"{np.bincount(pred, minlength=SCANNET_CLASSES).tolist()}", flush=True)
        require(pred.shape == (n,) and np.issubdtype(pred.dtype, np.integer)
                and pred.min() >= 0 and pred.max() < SCANNET_CLASSES, f"{name}: predictions")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # bfloat16 products summed in float32, as the reference's are
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("build"):
        print(f"card: {card_line()}", flush=True)
        t0 = time.perf_counter()
        lib_path = build.build()
        build.library()
        print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s", flush=True)

    ev_serve = VotingEvaluator(room0(), None, NUM_CLASSES, N, batch_size=B, voxel_size=0.04, seed=0)
    _, batch = ev_serve.next_batch(np.random.default_rng(0), ev_serve.clouds)
    del ev_serve

    with phase("kernels"):
        grid = grid_cloud(np.random.default_rng(1), B, N)
        topk_err = check_kernels(dev, [("integer grid", grid, True),
                                       ("synthetic crop", batch["points"], False)])
        check_topk_modes(dev, grid)
        check_gather_widths(dev)

    with phase("serve"):
        served = serve(dev, batch)
        step, predict, launches = served["step"], served["predict"], served["launches"]
        calls = served.pop("calls")

    with phase("timing"):
        max_err = {"window_topk": topk_err, "window_gather": 0.0}
        serve_summary = time_calls(calls, dev, launches, max_err, SERVE_KERNELS)
        time_spread(calls, dev, ("window_topk",))
        del calls

    with phase("profile"):
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, PyramidSpec()), reps=3)
        step_ms = time_ms(lambda: step(batch), reps=3)
        print(f"device time: pyramid {pyr_ms:.3f} ms, whole step {step_ms:.3f} ms", flush=True)
        profile_request(step, batch)

    with phase("voting"):
        voting(predict)

    with phase("stale-serve"):
        stale_served = serve(dev, batch, "stale", served["probs"])
        n_fwd = stale_served["launches"]["pt_attn_fwd"]
        require(n_fwd == ATTENTION_LAYERS, f"pt_attn_fwd: {n_fwd} launches, not {ATTENTION_LAYERS}")
        print(f"stale request median {stale_served['med'] * 1e3:.3f} ms beside the batch-BN "
              f"request's {served['med'] * 1e3:.3f} ms", flush=True)
        voting(stale_served["predict"], "stale request")
        records = []
        stale_summary = time_calls(stale_served.pop("calls"), dev, stale_served["launches"],
                                   {"pt_attn_fwd": 0.0}, ("pt_attn_fwd",), records=records)
        print_widths(records)
    f32_serve = dict(probs=served["probs"], med=served["med"], peak=served["peak"],
                     launches=served["launches"])
    stale_serve = dict(probs=stale_served["probs"], launches=stale_served["launches"])
    del served, stale_served, step, predict
    torch.cuda.empty_cache()

    with phase("train"), cbl_route_env("dense"):
        train = run_train(dev)

    with phase("train-kernels"), cbl_route_env("dense"):
        train_summary = check_train_kernels(dev, train)
    batch_launches, batch_peak = train["launches"], train["peak"]
    dense_med, dense_metrics = train["med"], train["metrics"]
    f32_steps = {"batch": {k: train[k] for k in ("loss", "grad_norm", "med", "peak", "busy_ms")}}
    del train
    torch.cuda.empty_cache()

    with phase("stale-train"), cbl_route_env("dense"):
        stale = run_train(dev, "stale")
        launches = stale["launches"]
        for name in ("pt_attn_fwd", "pt_attn_bwd"):
            require(launches[name] == ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches, not {ATTENTION_LAYERS}")
        for name in ("window_gather", "window_gather_bwd"):
            require(launches[name] == batch_launches[name] - ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches under stale BN vs "
                    f"{batch_launches[name]} under batch BN")
        print(f"peak memory of the stale step {stale['peak']} B vs the batch step {batch_peak} B",
              flush=True)

    with phase("stale-kernels"), cbl_route_env("dense"):
        train_summary += check_stale_kernels(dev, stale)
    f32_steps["stale"] = {k: stale[k] for k in ("loss", "grad_norm", "med", "peak", "busy_ms")}
    del stale
    torch.cuda.empty_cache()

    route_metrics = {"dense": dense_metrics}
    with phase("cbl-xla"), cbl_route_env("xla"):
        xla = run_train(dev, route="xla")
        for name in ("window_gather", "window_gather_bwd"):
            require(xla["launches"][name] == batch_launches[name] + STAGES,
                    f"{name}: {xla['launches'][name]} launches on the XLA tile route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"XLA tile route: step median {xla['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {xla['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["xla"] = xla["metrics"]
    del xla
    torch.cuda.empty_cache()

    with phase("cbl-pallas"), cbl_route_env("pallas"):
        pallas = run_train(dev, route="pallas")
        for name in PATH_KERNELS:
            require(pallas["launches"][name] == batch_launches[name],
                    f"{name}: {pallas['launches'][name]} launches on the v2 route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"v2 route: step median {pallas['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {pallas['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["pallas"] = pallas["metrics"]
        check_routes(route_metrics)

    with phase("cbl-kernels"):
        train_summary += check_cbl_kernels(dev, pallas)
    del pallas
    torch.cuda.empty_cache()

    with phase("plan-shapes"):
        check_plan_shapes(dev)

    def bf16_serve(bn_mode):
        out = serve(dev, batch, bn_mode, f32_serve["probs"], dtype=BF16)
        print(f"bfloat16 request ({bn_mode} BN): median {out['med'] * 1e3:.3f} ms, peak memory "
              f"{out['peak']} B, beside the float32 batch-BN request's {f32_serve['med'] * 1e3:.3f}"
              f" ms, {f32_serve['peak']} B", flush=True)
        voting(out["predict"], f"bfloat16 {bn_mode}-BN request", steps=1)
        return out

    def bf16_train(bn_mode):
        out, ref = run_train(dev, bn_mode, dtype=BF16), f32_steps[bn_mode]
        print(f"bfloat16 vs float32 step ({bn_mode} BN), same weights and batch: loss "
              f"{out['loss']:.7f} vs {ref['loss']:.7f} (rel "
              f"{abs(out['loss'] - ref['loss']) / abs(ref['loss']):.3g}), gradient norm "
              f"{out['grad_norm']:.7f} vs {ref['grad_norm']:.7f} (rel "
              f"{abs(out['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.3g})", flush=True)
        print(f"bfloat16 step ({bn_mode} BN): median {out['med'] * 1e3:.3f} ms, peak memory "
              f"{out['peak']} B, busy share {out['busy_ms'] / (out['med'] * 1e3):.3f}; float32 "
              f"step of this run: {ref['med'] * 1e3:.3f} ms, {ref['peak']} B, busy share "
              f"{ref['busy_ms'] / (ref['med'] * 1e3):.3f}; PERF.md's float32 step: "
              f"{F32_STEP_PERF}", flush=True)
        return out

    bf16_launches, bf16_served = {}, {}

    def keep_served(out):
        return {k: out[k] for k in ("probs", "launches", "by_dtype")}

    with phase("bf16-serve"):
        out = bf16_serve("batch")
        require_bf16_counts(out["by_dtype"], {"window_gather": {"bfloat16": ATTENTION_LAYERS}},
                            "a bfloat16 batch-BN request")
        bf16_served["batch"] = keep_served(out)
        del out
    with phase("bf16-train"), cbl_route_env("dense"):
        bf16_step = bf16_train("batch")
        require_bf16_counts(bf16_step["by_dtype"], BF16_STEP_GATHERS, "a bfloat16 batch-BN step")
        bf16_calls = bf16_calls_on_host(bf16_step["calls"],
                                        ("window_gather_bf16", "window_gather_bwd_bf16"))
        for name in ("window_gather", "window_gather_bwd"):
            bf16_launches[f"{name}_bf16"] = bf16_step["by_dtype"][name]["bfloat16"]
        del bf16_step
    torch.cuda.empty_cache()
    with phase("bf16-stale"), cbl_route_env("dense"):
        out = bf16_serve("stale")
        require_bf16_counts(out["by_dtype"], {"pt_attn_fwd": {"bfloat16": ATTENTION_LAYERS}},
                            "a bfloat16 stale request")
        bf16_served["stale"] = keep_served(out)
        del out
        stale_bf16 = bf16_train("stale")
        attn = {"bfloat16": ATTENTION_LAYERS, "float32": 0}
        require_bf16_counts(stale_bf16["by_dtype"], {"pt_attn_fwd": attn, "pt_attn_bwd": attn},
                            "a bfloat16 stale step")
        bf16_calls.update(bf16_calls_on_host(stale_bf16["calls"],
                                             ("pt_attn_fwd_bf16", "pt_attn_bwd_bf16")))
        for name in ("pt_attn_fwd", "pt_attn_bwd"):
            bf16_launches[f"{name}_bf16"] = stale_bf16["by_dtype"][name]["bfloat16"]
        del stale_bf16
    torch.cuda.empty_cache()
    with phase("bf16-kernels"), cbl_route_env("dense"):
        bf16_summary = check_bf16_kernels(dev, bf16_calls, bf16_launches)
    del bf16_calls
    torch.cuda.empty_cache()

    with phase("eval-features"):
        print(f"card: {card_line()}", flush=True)
        feat = eval_features(dev, batch, f32_serve)
        stale_feat = eval_features(dev, batch, stale_serve, "stale")
        n_fwd = stale_feat["launches"]["pt_attn_fwd"]
        require(n_fwd == ATTENTION_LAYERS, f"pt_attn_fwd: {n_fwd} launches, not {ATTENTION_LAYERS}")
        f32_feats = {"batch": feat["feats"], "stale": stale_feat["feats"]}
        del stale_feat, stale_serve
    with phase("voting-features"):
        print(f"card: {card_line()}", flush=True)
        voting_features(dev, feat["model"])
    with phase("enumerate"):
        print(f"card: {card_line()}", flush=True)
        enumerate_room(dev, feat["model"], CKPT.exists())
    del feat
    torch.cuda.empty_cache()
    with phase("bf16-eval-features"):
        print(f"card: {card_line()}", flush=True)
        for mode in ("batch", "stale"):
            out = eval_features(dev, batch, bf16_served[mode], mode, BF16, f32_feats[mode])
            del out
        del bf16_served, f32_feats
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cbl_entry_") as tmp:
        root = Path(tmp)
        with phase("train-entry"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            (root / "data").mkdir()
            t0 = time.perf_counter()
            write_s3dis_rooms(root / "data")
            print(f"wrote {ENTRY_ROOMS} + 1 rooms of {ENTRY_POINTS} points in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            train_entry(dev, root, batch, batch_launches)
        torch.cuda.empty_cache()
        with phase("train-entry-bf16"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            train_entry_bf16(root)
        torch.cuda.empty_cache()
        with phase("prepare-test"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            prepare_test(root, f32_serve["launches"], batch_launches)
    torch.cuda.empty_cache()

    summary = []
    for entry in train_summary:
        per_request = next(
            (e for e in serve_summary + stale_summary if e["name"] == entry["name"]), None)
        if per_request is None:
            summary.append(entry)
        else:
            summary.append({**per_request, "train": {k: entry[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    summary += bf16_summary  # per bfloat16 train step
    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

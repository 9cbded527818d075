"""Named presets (counterpart of contrastboundary_tpu/config/s3dis.py: the
same names and fields, so ``sorted(CONFIGS)`` and every preset equal the JAX
package's).

Reference sources:
  pytorch/config/s3dis/origin_multi-Ua-concat-latent_contrast-Ua-softnn-
  latent-label-l2-w.1.yaml — the 71.6-mIoU flagship (voxel 0.04, voxel_max
  80000, batch 16, lr 0.5 multistep ×0.1 @ {0.6, 0.8}·epochs, 200 epochs,
  contrast nsample [36,24,24,24,24]);
  tensorflow/config/s3dis.py:16-96 — ConvNet recipe (600 epochs, SGD m=0.98,
  lr 0.01 × 0.9885531^epoch, grad clip 100).

The port builds every preset: the point transformer on the sorted layout
(s3dis_pt_cbl, s3dis_pt_cbl_kl, s3dis_pt_cbl_bf16, and s3dis_pt with the
plain mlp head) and on the natural one with bucketed FPS
(s3dis_pt_cbl_paper, scannet_pt_cbl, synthetic_tiny, synthetic_full,
default), and the ConvNet on the natural layout with the voxel sampler
(s3dis_conv_cbl, s3dis_conv_cbl_kl, s3dis_pospool_cbl,
s3dis_pseudogrid_cbl, scannet_conv_cbl, semantic3d_conv_cbl,
npm3d_conv_cbl, s3dis_conv_cbl_paper, synthetic_conv_tiny) or the random
one (s3dis_randla_cbl).
"""
from .base import register_config

# flagship: point-transformer + CBL on S3DIS
# production presets run the Morton-sorted tile fast path (PERF.md round 2:
# 3x the natural-layout throughput). SHIP DECISION (round-5 parity campaign,
# ABLATION.md round 5): the checkpoint-controlled 2x2 matrix over the clean
# seeds measures mean totalD +0.99 mIoU IN FAST'S FAVOR (eval effect
# +3.0..+4.8 fast-favored on every seed, train effect -2.1..-3.5, net
# positive) — sorted+strided stays the default per the round-3 decision
# rule (|totalD| bounded < 1 with fast ahead). The *_paper presets keep
# layout='natural' for protocol-exact reference parity.
register_config(
    "s3dis_pt_cbl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    model={"layout": "sorted", "sampler": "strided"},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# baseline without CBL (origin_4gpu.yaml)
register_config(
    "s3dis_pt",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    model={"layout": "sorted", "sampler": "strided"},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    arch_out="",
)

# kl posmask variant (ConvNet table row 'CBL(kl)'; here on the PT backbone)
register_config(
    "s3dis_pt_cbl_kl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    model={"layout": "sorted", "sampler": "strided"},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-labelkl.5-l2-w.1",
)

# bfloat16 fast-path variant (bench.py's configuration): identical to
# s3dis_pt_cbl plus model.dtype=bfloat16 (loss math stays f32 —
# losses/contrast.py); measured 759k pts/s/chip vs 620k at f32 (PERF.md)
register_config(
    "s3dis_pt_cbl_bf16",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    model={"layout": "sorted", "sampler": "strided", "dtype": "bfloat16"},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# ConvNet + CBL (the 69.4-mIoU row: adaptive_weight aggregation,
# tensorflow/config/s3dis/adapt.yaml; 600 epochs × 500 steps, SGD m=0.98,
# lr 0.02 × 0.9885531^epoch, grad clip 100, weight decay as L2 1e-3)
register_config(
    "s3dis_conv_cbl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13,
          "crop_mode": "radius", "in_radius": 2.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# ConvNet + CBL(kl) (the 69.5-mIoU row)
register_config(
    "s3dis_conv_cbl_kl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13,
          "crop_mode": "radius", "in_radius": 2.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-labelkl.5-l2-w.1",
)

# PosPool + CBL (pospool.yaml: sin_cos embedding, mean reduction)
register_config(
    "s3dis_pospool_cbl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13,
          "crop_mode": "radius", "in_radius": 2.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "pospool",
           "agg_kwargs": (("position_embedding", "sin_cos"),
                          ("reduction", "mean")),
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# PseudoGrid (KPConv) + CBL (pseudogrid.yaml)
register_config(
    "s3dis_pseudogrid_cbl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13,
          "crop_mode": "radius", "in_radius": 2.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "pseudo_grid",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# synthetic ConvNet smoke config
register_config(
    "synthetic_conv_tiny",
    data={"dataset": "synthetic", "num_rooms": 8, "points_per_room": 40000,
          "voxel_size": 0.06, "voxel_max": 4096, "n_points": 4096,
          "loop": 4, "num_classes": 13},
    model={"arch": "convnet", "base_fdim": 36, "aggregation": "adaptive_weight",
           "sampler": "voxel", "base_radius": 0.15,
           "contrast_nsample": (16, 16, 16, 16, 16),
           "neighborhood_limits": (16, 20, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 10, "batch_size": 4},
    eval={"num_votes": 1.0, "batch_size": 4},
    log_freq=5,
)

# synthetic smoke/convergence configs (no S3DIS download needed)
register_config(
    "synthetic_tiny",
    data={"dataset": "synthetic", "num_rooms": 8, "points_per_room": 40000,
          "voxel_size": 0.06, "voxel_max": 4096, "n_points": 4096,
          "loop": 4, "num_classes": 13},
    model={"planes": (16, 32, 64, 128, 256), "blocks": (2, 2, 2, 2, 2),
           "base_fdim": 16},
    optim={"base_lr": 0.1, "epochs": 10, "batch_size": 4},
    eval={"num_votes": 1.0, "batch_size": 4},
    log_freq=5,
)

register_config(
    "synthetic_full",
    data={"dataset": "synthetic", "num_rooms": 16, "points_per_room": 120000,
          "voxel_size": 0.04, "voxel_max": 16384, "n_points": 16384,
          "loop": 8, "num_classes": 13},
    optim={"base_lr": 0.5, "epochs": 30, "batch_size": 4},
    eval={"num_votes": 2.0},
)

register_config("default", data={"dataset": "synthetic"})

# ScanNet ConvNet + CBL (tensorflow/config/scannet.py:6-153: 20 classes,
# dl=0.04, in_radius 2.0, same ConvNet recipe)
register_config(
    "scannet_conv_cbl",
    data={"dataset": "scannet", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 20,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

register_config(
    "scannet_pt_cbl",
    data={"dataset": "scannet", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 20},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# Semantic3D / NPM3D ConvNet + CBL. The reference ships the dataset classes
# (tf_semantic3d_dataset.py, tf_npm3d_dataset.py) but publishes no config
# module for them; these presets apply the ConvNet recipe with
# dataset-scale voxel sizes (outdoor scans are far larger than indoor rooms).
register_config(
    "semantic3d_conv_cbl",
    data={"dataset": "semantic3d", "voxel_size": 0.06, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 8, "crop_mode": "radius",
          "in_radius": 3.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "base_radius": 0.15,
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 400, "batch_size": 8},
    eval={"num_votes": 20.0, "smooth": 0.98},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

register_config(
    "npm3d_conv_cbl",
    data={"dataset": "npm3d", "voxel_size": 0.08, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 9, "crop_mode": "radius",
          "in_radius": 4.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "base_radius": 0.2,
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 400, "batch_size": 8},
    eval={"num_votes": 20.0, "smooth": 0.98},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# RandLA-Net-style baseline + CBL (BASELINE.json configs[1]): uniform random
# decimation replaces FPS/grid sampling, and the local aggregation is
# attentive pooling — AdaptiveWeight with a masked softmax over neighbor
# weights (the reference's AdaptiveWeight 'mask' softmax variant,
# tensorflow/models/local_aggregation_operators.py:316-500).
register_config(
    "s3dis_randla_cbl",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "agg_kwargs": (("weight_softmax", "mask"),),
           "sampler": "random", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 400, "batch_size": 8},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

# Protocol-faithful parity eval presets: the reference's published numbers
# use >=20 vote rounds with smoothing 0.95 on val (tensorflow/config/
# s3dis.py:52, utils/tester.py:106). Any reported accuracy should come from
# these, not the smoke-eval defaults.
register_config(
    "s3dis_pt_cbl_paper",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 80000,
          "n_points": 65536, "loop": 30, "num_classes": 13},
    optim={"base_lr": 0.5, "momentum": 0.9, "weight_decay": 1e-4,
           "schedule": "multistep", "milestones": (0.6, 0.8),
           "multiplier": 0.1, "epochs": 200, "batch_size": 16},
    eval={"num_votes": 20.0, "smooth": 0.95, "batch_size": 4},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

register_config(
    "s3dis_conv_cbl_paper",
    data={"dataset": "s3dis", "voxel_size": 0.04, "voxel_max": 65536,
          "n_points": 65536, "loop": 30, "num_classes": 13,
          "crop_mode": "radius", "in_radius": 2.0,
          "sampler": "potential"},
    model={"arch": "convnet", "base_fdim": 72, "aggregation": "adaptive_weight",
           "sampler": "voxel", "strides": (1, 4, 4, 4, 4),
           "contrast_nsample": (36, 24, 24, 24, 24)},
    optim={"base_lr": 0.02, "momentum": 0.98, "weight_decay": 1e-3,
           "schedule": "exponential", "decay_rate": 0.9885531,
           "grad_clip_norm": 100.0, "epochs": 600, "batch_size": 8},
    eval={"num_votes": 20.0, "smooth": 0.95, "batch_size": 4},
    arch_out="multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1",
)

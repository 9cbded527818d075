"""Point-transformer blocks for inference (counterpart of
contrastboundary_tpu/models/blocks.py:177-458, the XLA path of
PointTransformerLayer, not the fused ``pt_attn`` kernel).

Submodule names are the flax names of the JAX modules, so a flax variable
path maps onto a state_dict key one to one (models/convert.py). Neighbour
indices are window-relative in Morton-sorted space (ops/pyramid.py) and every
neighbour read is a tile gather (ops/tile_gather.py).

BatchNorm is eval-only: it normalizes with the running statistics, as flax
``nn.BatchNorm(use_running_average=True)`` does (eps 1e-5, over the last
axis). Training BN waits for the training slice of the port.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.tile_gather import cross_window_gather, tile_window_gather


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis: (x − mean)·(scale/√(var + eps))
    + bias, in the order flax computes it."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class PointTransformerLayer(nn.Module):
    """Vector self-attention over k neighbours:
    w = linear_w(k_nb − q + δ), out = Σ_k softmax_k(w) ⊙ (v_nb + δ), with
    δ = linear_p(p_nb − p) and ``share_planes`` channels per weight."""

    def __init__(self, planes: int, share_planes: int = 8):
        super().__init__()
        c, s = planes, share_planes
        self.share_planes = s
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c)
        self.p_fc1 = nn.Linear(3, 3)
        self.p_bn = BatchNorm(3)
        self.p_fc2 = nn.Linear(3, c)
        self.w_bn1 = BatchNorm(c)
        self.w_fc1 = nn.Linear(c, c // s)
        self.w_bn2 = BatchNorm(c // s)
        self.w_fc2 = nn.Linear(c // s, c // s)

    def forward(self, x, nb_idx, rel, local):
        tile, width = local
        c, s = x.shape[-1], self.share_planes
        q = self.linear_q(x)
        kv = torch.cat([self.linear_k(x), self.linear_v(x)], -1)
        kv_nb = tile_window_gather(kv, nb_idx, tile, width)
        k_nb, v_nb = kv_nb[..., :c], kv_nb[..., c:]

        pe = self.p_fc2(F.relu(self.p_bn(self.p_fc1(rel))))
        w = k_nb - q[:, :, None, :] + pe
        w = self.w_fc1(F.relu(self.w_bn1(w)))
        w = self.w_fc2(F.relu(self.w_bn2(w)))
        # shadow slots (tiny levels); slot 0 is the query itself, so no row
        # is all shadow
        w = w.masked_fill((nb_idx == tile * width)[..., None], float("-inf"))
        w = torch.softmax(w, dim=2)

        b, n, kk, _ = v_nb.shape
        vp = (v_nb + pe).reshape(b, n, kk, s, c // s)
        return (vp * w[:, :, :, None, :]).sum(2).reshape(b, n, c)


class PointTransformerBlock(nn.Module):
    """Dense+BN+ReLU → attention+BN+ReLU → Dense+BN, then ReLU(x + identity)."""

    def __init__(self, planes: int, share_planes: int = 8):
        super().__init__()
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = BatchNorm(planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes)
        self.bn2 = BatchNorm(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = BatchNorm(planes)

    def forward(self, x, nb_idx, rel, local):
        y = F.relu(self.bn1(self.linear1(x)))
        y = F.relu(self.bn2(self.transformer2(y, nb_idx, rel, local)))
        y = self.bn3(self.linear3(y))
        return F.relu(y + x)


class TransitionDown(nn.Module):
    """stride 1: Dense(no bias)+BN+ReLU. stride > 1: one cross-window gather
    of [p_prev | x_prev], relative xyz, Dense(no bias)+BN+ReLU, max over k."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        extra = 3 if stride > 1 else 0
        self.Dense_0 = nn.Linear(in_planes + extra, out_planes, bias=False)
        self.BatchNorm_0 = BatchNorm(out_planes)

    def forward(self, p_prev, x_prev, p_cur=None, local=None):
        if self.stride == 1:
            return F.relu(self.BatchNorm_0(self.Dense_0(x_prev)))
        li, tile, width, window = local
        fused = torch.cat([p_prev, x_prev], -1)
        nb = cross_window_gather(fused, li, p_prev.shape[1], tile, width, window)
        rel = nb[..., :3] - p_cur[:, :, None, :]
        rel = torch.where((li < tile * width)[..., None], rel, 0.0)
        g = torch.cat([rel, nb[..., 3:]], -1)
        g = F.relu(self.BatchNorm_0(self.Dense_0(g)))
        return g.amax(2)


class TransitionUp(nn.Module):
    """Decoder fusion: linear1(x_skip) + IDW-interp(linear2(x_deep)), each
    linear a Dense+BN+ReLU; the head variant (``is_head``) concatenates the
    per-cloud mean through linear2 = Dense+ReLU instead."""

    def __init__(self, in_planes: int, out_planes: int, is_head: bool = False):
        super().__init__()
        self.is_head = is_head
        self.linear2_fc = nn.Linear(in_planes, out_planes)
        self.linear2_bn = None if is_head else BatchNorm(out_planes)
        d_skip = in_planes + out_planes if is_head else out_planes
        self.linear1_fc = nn.Linear(d_skip, out_planes)
        self.linear1_bn = BatchNorm(out_planes)

    def _linear1(self, x):
        return F.relu(self.linear1_bn(self.linear1_fc(x)))

    def forward(self, x_skip, x_deep=None, up_w=None, local=None):
        if self.is_head:
            g = F.relu(self.linear2_fc(x_skip.mean(1, keepdim=True)))
            return self._linear1(
                torch.cat([x_skip, g.expand(-1, x_skip.shape[1], -1)], -1)
            )
        deep = F.relu(self.linear2_bn(self.linear2_fc(x_deep)))
        li, tile, width, window = local
        deep_up = cross_window_gather(deep, li, deep.shape[1], tile, width, window)
        deep_up = (deep_up * up_w[..., None]).sum(2)
        return self._linear1(x_skip) + deep_up


class MLPTower(nn.Module):
    """Dense+BN+ReLU per width in ``dims`` (submodules fc<i>, bn<i>)."""

    def __init__(self, d_in: int, dims: Sequence[int]):
        super().__init__()
        self.depth = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"fc{i}", nn.Linear(d_in, d))
            self.add_module(f"bn{i}", BatchNorm(d))
            d_in = d

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return x

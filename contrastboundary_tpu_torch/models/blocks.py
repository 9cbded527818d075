"""Point-transformer blocks (counterpart of
contrastboundary_tpu/models/blocks.py:177-458, the XLA path of
PointTransformerLayer, not the fused ``pt_attn`` kernel, which the reference
runs only under bn_mode='stale').

Submodule names are the flax names of the JAX modules, so a flax variable
path maps onto a state_dict key one to one (models/convert.py). Neighbour
indices are window-relative in Morton-sorted space (ops/pyramid.py) and every
neighbour read is a tile gather (ops/tile_gather.py).

BatchNorm is flax ``nn.BatchNorm`` over the last axis (eps 1e-5, momentum
0.9, the reference's bn_mode='batch'): in eval mode it normalizes with the
running statistics; in train mode with the batch statistics. Under
bn_mode='stale' every BN is a StaleBatchNorm, and each attention layer runs
the fused kernel (ops/pt_attn.py) with its BNs folded into the towers, as
the reference does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pt_attn import pt_attn
from ..ops.tile_gather import cross_window_gather, tile_window_gather


class BatchNorm(nn.Module):
    """BatchNorm over the last axis as flax computes it: (x − mean)·(scale /
    √(var + eps)) + bias.

    Train mode uses flax's fast variance: mean and E[x²] in float32 over
    every axis but the last, var = max(0, E[x²] − mean²), the biased
    variance both to normalize and for the running update ra ← 0.9·ra +
    0.1·batch, done in place without gradient. (``F.batch_norm`` keeps the
    unbiased variance and the other momentum convention, so it is not used.)
    Eval mode normalizes with the running statistics."""

    momentum = 0.9  # flax's, the reference's

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class StaleBatchNorm(BatchNorm):
    """BatchNorm that normalizes with the running statistics of before the
    step, y = x·inv + (bias − mean·inv) with inv = rsqrt(var + eps)·scale,
    and in train mode still updates them from the batch's fast-variance
    statistics, without gradient (counterpart of the JAX StaleBatchNorm).
    The normalization is then a per-channel affine known before the step,
    which the fused attention kernel folds into its towers (``fold``,
    ``update``). Parameter and buffer names are BatchNorm's, so one flax
    tree loads into either mode; in eval mode the two compute the same
    function."""

    def fold(self):
        """(scale', shift') of y = x·scale' + shift' from the pre-update
        running statistics; the gradient reaches weight and bias."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean.clone() * s

    @torch.no_grad()
    def update(self, mean, mean_sq):
        """Running update from a batch's mean and mean of squares (fast
        variance max(0, E[x²] − E[x]²))."""
        m = self.momentum
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x):
        scale, shift = self.fold()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            xf = x.detach().float()
            self.update(xf.mean(axes), (xf * xf).mean(axes))
        return x.float() * scale + shift


def make_bn(mode: str, features: int) -> BatchNorm:
    """The BN of every block: 'batch' = flax nn.BatchNorm (the reference's
    default), 'stale' = StaleBatchNorm."""
    if mode == "batch":
        return BatchNorm(features)
    if mode == "stale":
        return StaleBatchNorm(features)
    raise ValueError(f"bn_mode {mode!r} is neither 'batch' nor 'stale'")


class PointTransformerLayer(nn.Module):
    """Vector self-attention over k neighbours:
    w = linear_w(k_nb − q + δ), out = Σ_k softmax_k(w) ⊙ (v_nb + δ), with
    δ = linear_p(p_nb − p) and ``share_planes`` channels per weight."""

    def __init__(self, planes: int, share_planes: int = 8, bn_mode: str = "batch"):
        super().__init__()
        c, s = planes, share_planes
        self.share_planes = s
        self.stale = bn_mode == "stale"
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c)
        self.p_fc1 = nn.Linear(3, 3)
        self.p_bn = make_bn(bn_mode, 3)
        self.p_fc2 = nn.Linear(3, c)
        self.w_bn1 = make_bn(bn_mode, c)
        self.w_fc1 = nn.Linear(c, c // s)
        self.w_bn2 = make_bn(bn_mode, c // s)
        self.w_fc2 = nn.Linear(c // s, c // s)

    def forward(self, x, nb_idx, rel, local):
        tile, width = local
        c, s = x.shape[-1], self.share_planes
        q = self.linear_q(x)
        kv = torch.cat([self.linear_k(x), self.linear_v(x)], -1)
        if self.stale:
            return self._fused(q, kv, nb_idx, rel, tile, width)
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

    def _fused(self, q, kv, nb_idx, rel, tile, width):
        """The whole attention in the fused kernel, with the three stale BNs
        folded into the 12 tower arrays (nn.Linear's [out, in] weights
        transposed into the kernel's [in, out]); in train mode the running
        updates follow: w_bn1 and w_bn2 from the kernel's batch statistics,
        p_bn by moment algebra over rel (its input is affine in rel)."""
        sp, hp = self.p_bn.fold()
        g1, h1 = self.w_bn1.fold()
        g2, h2 = self.w_bn2.fold()
        w1, b1 = self.p_fc1.weight.T, self.p_fc1.bias
        params = (
            w1 * sp, (b1 * sp + hp)[None], self.p_fc2.weight.T, self.p_fc2.bias[None],
            g1[None], h1[None], self.w_fc1.weight.T, self.w_fc1.bias[None],
            g2[None], h2[None], self.w_fc2.weight.T, self.w_fc2.bias[None],
        )
        out, s1, s2 = pt_attn(q, kv, rel.float(), nb_idx, tile, width, params)
        if self.training:
            self.w_bn1.update(*s1)
            self.w_bn2.update(*s2)
            with torch.no_grad():
                rf = rel.float().reshape(-1, 3)
                m2 = rf.T @ rf / rf.shape[0]
                w1, b1 = w1.detach(), b1.detach()
                mw = rf.mean(0) @ w1
                pe1_sq = torch.einsum("ij,ik,kj->j", w1, m2, w1) + 2.0 * b1 * mw + b1 * b1
                self.p_bn.update(mw + b1, pe1_sq)
        return out


class PointTransformerBlock(nn.Module):
    """Dense+BN+ReLU → attention+BN+ReLU → Dense+BN, then ReLU(x + identity)."""

    def __init__(self, planes: int, share_planes: int = 8, bn_mode: str = "batch"):
        super().__init__()
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = make_bn(bn_mode, planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes, bn_mode)
        self.bn2 = make_bn(bn_mode, planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = make_bn(bn_mode, planes)

    def forward(self, x, nb_idx, rel, local):
        y = F.relu(self.bn1(self.linear1(x)))
        y = F.relu(self.bn2(self.transformer2(y, nb_idx, rel, local)))
        y = self.bn3(self.linear3(y))
        return F.relu(y + x)


class TransitionDown(nn.Module):
    """stride 1: Dense(no bias)+BN+ReLU. stride > 1: one cross-window gather
    of [p_prev | x_prev], relative xyz, Dense(no bias)+BN+ReLU, max over k."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 bn_mode: str = "batch"):
        super().__init__()
        self.stride = stride
        extra = 3 if stride > 1 else 0
        self.Dense_0 = nn.Linear(in_planes + extra, out_planes, bias=False)
        self.BatchNorm_0 = make_bn(bn_mode, out_planes)

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

    def __init__(self, in_planes: int, out_planes: int, is_head: bool = False,
                 bn_mode: str = "batch"):
        super().__init__()
        self.is_head = is_head
        self.linear2_fc = nn.Linear(in_planes, out_planes)
        self.linear2_bn = None if is_head else make_bn(bn_mode, out_planes)
        d_skip = in_planes + out_planes if is_head else out_planes
        self.linear1_fc = nn.Linear(d_skip, out_planes)
        self.linear1_bn = make_bn(bn_mode, out_planes)

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

    def __init__(self, d_in: int, dims: Sequence[int], bn_mode: str = "batch"):
        super().__init__()
        self.depth = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"fc{i}", nn.Linear(d_in, d))
            self.add_module(f"bn{i}", make_bn(bn_mode, d))
            d_in = d

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return x

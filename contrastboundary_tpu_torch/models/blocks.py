"""Point-transformer blocks (counterpart of
contrastboundary_tpu/models/blocks.py:177-458).

Submodule names are the flax names of the JAX modules, so a flax variable
path maps onto a state_dict key one to one (models/convert.py). Each block
takes one of the pyramid's two routes (ops/pyramid.py), as the reference
chooses by whether ``local`` is given: on the sorted layout the neighbour
indices are window-relative in Morton-sorted space and every neighbour read
is a tile gather (ops/tile_gather.py); on the natural layout (``local``
None) they are global rows, read by a row gather that reads the shadow
index N as row N − 1 and drops its cotangent, as XLA's gather and its
transpose do (core/gather.py::clamped_gather), and the attention's softmax
masks no slot, as the reference's does not.

BatchNorm is flax ``nn.BatchNorm`` over the last axis (eps 1e-5, momentum
0.9 by default, the point transformer's; the ConvNet family passes its own,
models/convnet.py): in eval mode it normalizes with the running
statistics; in train mode with the batch statistics, which are the global
batch's across the ranks of a process group (parallel/mesh.py), as the
JAX package's are under its batch-sharded jit. Under
bn_mode='stale' every BN is a StaleBatchNorm, and each attention layer of
the sorted layout runs the fused kernel (ops/pt_attn.py) with its BNs
folded into the towers, as the reference does; the natural layout's runs
the unfused layer, as the reference's (its kernel needs ``local``).

``dtype`` is the flax modules' compute dtype (float32, or bfloat16 as in the
reference's bf16 presets). Parameters stay float32. Each op rounds where the
JAX module's op of the same dtype does: each Dense as flax
nn.Dense(dtype=...) (``dense``), each ``dtype`` elementwise op once, each
jnp.sum of ``dtype`` values in float32 rounded once, and every BN computes
in float32 and returns float32 (the reference's default BN dtype), so
activations are ``dtype`` after a Dense and float32 after a BN.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.gather import clamped_gather
from ..ops.pt_attn import pt_attn
from ..ops.tile_gather import cross_window_gather, tile_window_gather
from ..parallel.mesh import global_means
from ..utils import threefry


def dense(layer: nn.Linear, x, dtype: torch.dtype):
    """flax nn.Dense(dtype=dtype): input, kernel and bias cast to ``dtype``,
    the product rounded to ``dtype``, then the bias added in ``dtype`` (two
    roundings, where a fused addmm would round once). float32 is the layer's
    own forward."""
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis as flax computes it: (x − mean)·(scale /
    √(var + eps)) + bias.

    Train mode uses flax's fast variance: mean and E[x²] in float32 over
    every axis but the last, var = max(0, E[x²] − mean²), the biased
    variance both to normalize and for the running update ra ← m·ra +
    (1 − m)·batch (m = ``momentum``, flax's 0.9 by default), done in place
    without gradient. (``F.batch_norm`` keeps the unbiased variance and the
    other momentum convention, and ``nn.SyncBatchNorm`` the unbiased running
    variance, so neither is used.) Across ranks the mean and E[x²] are the
    global batch's, from one differentiable all-reduce of the sums and the
    row count, so the gradient flows through the global statistics as
    flax's does through the batch's. Eval mode normalizes with the running
    statistics."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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
            mean, mean_sq = global_means([xf.mean(axes), (xf * xf).mean(axes)],
                                         xf.numel() // xf.shape[-1])
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x.float() - mean) * mul + self.bias


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
            self.update(*global_means([xf.mean(axes), (xf * xf).mean(axes)],
                                      xf.numel() // xf.shape[-1]))
        return x.float() * scale + shift


def make_bn(mode: str, features: int, eps: float = 1e-5,
            momentum: float = 0.9) -> BatchNorm:
    """The BN of every block: 'batch' = flax nn.BatchNorm (the reference's
    default), 'stale' = StaleBatchNorm."""
    if mode == "batch":
        return BatchNorm(features, eps, momentum)
    if mode == "stale":
        return StaleBatchNorm(features, eps, momentum)
    raise ValueError(f"bn_mode {mode!r} is neither 'batch' nor 'stale'")


class PointTransformerLayer(nn.Module):
    """Vector self-attention over k neighbours:
    w = linear_w(k_nb − q + δ), out = Σ_k softmax_k(w) ⊙ (v_nb + δ), with
    δ = linear_p(p_nb − p) and ``share_planes`` channels per weight."""

    def __init__(self, planes: int, share_planes: int = 8, bn_mode: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, s = planes, share_planes
        self.share_planes = s
        self.dtype = dtype
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
        """local: (tile, width) of window-relative ``nb_idx`` (sorted
        layout), or None for global rows (natural layout)."""
        c, s, dt = x.shape[-1], self.share_planes, self.dtype
        q = dense(self.linear_q, x, dt)
        kv = torch.cat([dense(self.linear_k, x, dt), dense(self.linear_v, x, dt)], -1)
        if local is None:
            kv_nb = clamped_gather(kv, nb_idx)
        elif self.stale:
            return self._fused(q, kv, nb_idx, rel, *local)
        else:
            kv_nb = tile_window_gather(kv, nb_idx, *local)
        k_nb, v_nb = kv_nb[..., :c], kv_nb[..., c:]

        pe = dense(self.p_fc2, F.relu(self.p_bn(dense(self.p_fc1, rel.to(dt), dt))), dt)
        w = k_nb - q[:, :, None, :] + pe
        w = dense(self.w_fc1, F.relu(self.w_bn1(w)), dt)
        w = dense(self.w_fc2, F.relu(self.w_bn2(w)), dt).float()
        if local is not None:
            # shadow slots (tiny levels); slot 0 is the query itself, so no
            # row is all shadow
            w = w.masked_fill((nb_idx == local[0] * local[1])[..., None], float("-inf"))
        w = torch.softmax(w, dim=2).to(dt)

        b, n, kk, _ = v_nb.shape
        vp = (v_nb + pe).reshape(b, n, kk, s, c // s)
        # jnp.sum of a dtype product: float32 sums, rounded once
        out = (vp * w[:, :, :, None, :]).sum(2, dtype=torch.float32).to(dt)
        return out.reshape(b, n, c)

    def _fused(self, q, kv, nb_idx, rel, tile, width):
        """The whole attention in the fused kernel, with the three stale BNs
        folded into the 12 tower arrays (nn.Linear's [out, in] weights
        transposed into the kernel's [in, out]); in train mode the running
        updates follow: w_bn1 and w_bn2 from the kernel's batch statistics,
        p_bn by moment algebra over rel (its input is affine in rel), each
        over the global batch across ranks (one all-reduce a layer). q and
        kv come in ``dtype`` and out leaves in it; the kernel computes in
        float32, and rel and the tower arrays are float32."""
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
            with torch.no_grad():
                rf = rel.float().reshape(-1, 3)
                a1, q1, a2, q2, mean_r, m2 = global_means(
                    [*s1, *s2, rf.mean(0), rf.T @ rf / rf.shape[0]], rf.shape[0])
                w1, b1 = w1.detach(), b1.detach()
                mw = mean_r @ w1
                pe1_sq = torch.einsum("ij,ik,kj->j", w1, m2, w1) + 2.0 * b1 * mw + b1 * b1
            self.w_bn1.update(a1, q1)
            self.w_bn2.update(a2, q2)
            self.p_bn.update(mw + b1, pe1_sq)
        return out


class PointTransformerBlock(nn.Module):
    """Dense+BN+ReLU → attention+BN+ReLU → Dense+BN, then ReLU(x + identity)."""

    def __init__(self, planes: int, share_planes: int = 8, bn_mode: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = make_bn(bn_mode, planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes, bn_mode, dtype)
        self.bn2 = make_bn(bn_mode, planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = make_bn(bn_mode, planes)

    def forward(self, x, nb_idx, rel, local):
        y = F.relu(self.bn1(dense(self.linear1, x, self.dtype)))
        y = F.relu(self.bn2(self.transformer2(y, nb_idx, rel, local)))
        y = self.bn3(dense(self.linear3, y, self.dtype))
        return F.relu(y + x)


class TransitionDown(nn.Module):
    """stride 1: Dense(no bias)+BN+ReLU. stride > 1: the neighbours'
    features with their relative xyz, Dense(no bias)+BN+ReLU, max over k;
    on the sorted layout one cross-window gather of [p_prev | x_prev]
    (``local``), on the natural one a row gather of x_prev at ``idx`` beside
    the pyramid's ``rel``."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 bn_mode: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        extra = 3 if stride > 1 else 0
        self.Dense_0 = nn.Linear(in_planes + extra, out_planes, bias=False)
        self.BatchNorm_0 = make_bn(bn_mode, out_planes)

    def forward(self, p_prev, x_prev, p_cur=None, local=None, idx=None, rel=None):
        dt = self.dtype
        if self.stride == 1:
            return F.relu(self.BatchNorm_0(dense(self.Dense_0, x_prev, dt)))
        if local is None:
            x_nb = clamped_gather(x_prev, idx)
        else:
            li, tile, width, window = local
            fused = torch.cat([p_prev.to(x_prev.dtype), x_prev], -1)
            nb = cross_window_gather(fused, li, p_prev.shape[1], tile, width, window)
            rel = nb[..., :3] - p_cur[:, :, None, :].to(nb.dtype)
            rel = torch.where((li < tile * width)[..., None], rel, 0.0)
            x_nb = nb[..., 3:]
        # rel rounded to dtype, then promoted with the features (JAX's concat)
        g = torch.cat([rel.to(dt).to(x_nb.dtype), x_nb], -1)
        g = F.relu(self.BatchNorm_0(dense(self.Dense_0, g, dt)))
        return g.amax(2)


class TransitionUp(nn.Module):
    """Decoder fusion: linear1(x_skip) + IDW-interp(linear2(x_deep)), each
    linear a Dense+BN+ReLU; the head variant (``is_head``) concatenates the
    per-cloud mean through linear2 = Dense+ReLU instead. The deep rows are
    read by a cross-window gather (``local``, sorted layout) or a row
    gather at ``idx`` (natural layout)."""

    def __init__(self, in_planes: int, out_planes: int, is_head: bool = False,
                 bn_mode: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.is_head = is_head
        self.dtype = dtype
        self.linear2_fc = nn.Linear(in_planes, out_planes)
        self.linear2_bn = None if is_head else make_bn(bn_mode, out_planes)
        d_skip = in_planes + out_planes if is_head else out_planes
        self.linear1_fc = nn.Linear(d_skip, out_planes)
        self.linear1_bn = make_bn(bn_mode, out_planes)

    def _linear1(self, x):
        return F.relu(self.linear1_bn(dense(self.linear1_fc, x, self.dtype)))

    def forward(self, x_skip, x_deep=None, up_w=None, local=None, idx=None):
        if self.is_head:
            # the mean through a Dense in dtype, promoted with x_skip
            g = F.relu(dense(self.linear2_fc, x_skip.mean(1, keepdim=True), self.dtype))
            return self._linear1(
                torch.cat([x_skip, g.expand(-1, x_skip.shape[1], -1).to(x_skip.dtype)], -1)
            )
        deep = F.relu(self.linear2_bn(dense(self.linear2_fc, x_deep, self.dtype)))
        if local is None:
            deep_up = clamped_gather(deep, idx)
        else:
            li, tile, width, window = local
            deep_up = cross_window_gather(deep, li, deep.shape[1], tile, width, window)
        deep_up = (deep_up * up_w[..., None].to(deep_up.dtype)).sum(2)
        return self._linear1(x_skip) + deep_up


class MLPTower(nn.Module):
    """Dense+BN+ReLU per width in ``dims`` (submodules fc<i>, bn<i>)."""

    def __init__(self, d_in: int, dims: Sequence[int], bn_mode: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(dims)
        self.dtype = dtype
        for i, d in enumerate(dims):
            self.add_module(f"fc{i}", nn.Linear(d_in, d))
            self.add_module(f"bn{i}", make_bn(bn_mode, d))
            d_in = d

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(dense(getattr(self, f"fc{i}"), x, self.dtype)))
        return x


def dropout_mask(key: threefry.Key, name: str, rate: float, shape, device) -> torch.Tensor:
    """The keep mask of flax's ``nn.Dropout(rate, name=name)``, a direct
    child of the model, under ``rngs={'dropout': key}``: a bernoulli draw of
    1 − rate from the key flax derives for the module's first rng call
    (``flax_fold(key, name, 1)``), drawn on ``device``."""
    return threefry.bernoulli(threefry.flax_fold(key, name, 1), 1.0 - rate, shape, device)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)`` named ``name`` (a direct child of the
    model): in train mode each element is kept where ``dropout_mask`` of
    the step's dropout key says so, and scaled by 1 / (1 − rate); zero
    elsewhere. The identity in eval mode. The key is the JAX trainer's
    ``fold_in(PRNGKey(17), step)`` (train/trainer.py), passed in by the
    caller; the mask is drawn on the tensor's device with the same bits on
    every device."""

    def __init__(self, rate: float, name: str):
        super().__init__()
        self.rate, self.name = float(rate), name

    def forward(self, x, key: Optional[threefry.Key]):
        if not self.training or self.rate == 0.0:
            return x
        if key is None:
            raise ValueError(f"{self.name}: a train-mode dropout needs the step's dropout key")
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = dropout_mask(key, self.name, self.rate, x.shape, x.device)
        scale = torch.tensor(np.float32(1.0 - self.rate), device=x.device)
        return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))

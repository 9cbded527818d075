"""The ConvNet family's local aggregation operators (counterpart of
contrastboundary_tpu/models/local_aggregation.py): PosPool, AdaptiveWeight
(the published ConvNet+CBL operator), PointWiseMLP, PseudoGrid (KPConv) and
Identity, over dense [B, M, K] neighbour lists of global rows with the
shadow index N marking an invalid slot (ops/pyramid.py, natural layout).
A masked mean divides by the valid count + 1e-5, a masked max fills
−65535, and relative positions are divided by the ball radius.

Each operator is an ``nn.Module`` built with its input width (flax infers
it); submodule and parameter names are the flax names, so a flax tree maps
onto the state_dict (models/convert.py). Their BatchNorms are flax
``nn.BatchNorm`` with the ConvNet's momentum and eps whatever the model's
bn_mode, as in the reference. Train or eval mode is the module's own.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.gather import shadow_gather
from ..core.masking import masked_softmax
from .blocks import BatchNorm

_NEG = -65535.0


def _gather_geometry(p_query, p_support, nb_idx, radius):
    """Shadow-masked neighbour geometry: the relative position over the
    radius (0 at shadows), its length, its direction, the valid mask."""
    nb_p, valid = shadow_gather(p_support, nb_idx, fill=0.0)
    rel = (nb_p - p_query[:, :, None, :]) / radius
    rel = torch.where(valid[..., None], rel, 0.0)
    dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    return rel, dist, rel / (dist + 1e-6), valid


def _reduce(agg, valid, reduction: str):
    """Masked reduction over the neighbour axis (dim 2) of agg [B, M, K, C]."""
    if reduction == "sum":
        return agg.sum(2)
    if reduction in ("mean", "avg"):
        cnt = valid.to(agg.dtype).sum(2)[..., None]
        return agg.sum(2) / (cnt + 1e-5)
    if reduction == "max":
        return torch.where(valid[..., None], agg, _NEG).amax(2)
    raise ValueError(f"unknown reduction {reduction!r}")


def _sincos_embedding(rel, fdim: int):
    """PosPool's sinusoidal embedding: rel [B, M, K, 3] → [B, M, K, 6·⌊fdim/6⌋]
    (+ rel when fdim is 9), sin then cos of each axis."""
    feat_dim = max(fdim // 6, 1)
    feat_range = torch.arange(feat_dim, dtype=torch.float32, device=rel.device)
    dim_mat = torch.pow(torch.tensor(1000.0, device=rel.device), feat_range / feat_dim)
    pos = (100.0 * rel)[..., None] / dim_mat
    emb = torch.cat([torch.sin(pos), torch.cos(pos)], -1)
    emb = emb.reshape(rel.shape[:-1] + (6 * feat_dim,))
    if fdim == 9:
        emb = torch.cat([emb, rel], -1)
    return emb


class _Agg(nn.Module):
    """Shared tail: BN + ReLU, then (when the width changes or asked) an
    output Dense with bias + BN + ReLU."""

    def __init__(self, in_fdim, out_fdim, output_conv, bn_momentum, bn_eps,
                 bn_name="pool_bn"):
        super().__init__()
        self.in_fdim, self.out_fdim = in_fdim, out_fdim
        self.bn_name = bn_name
        self.add_module(bn_name, BatchNorm(in_fdim, bn_eps, bn_momentum))
        self.has_output = in_fdim != out_fdim or output_conv
        if self.has_output:
            self.output_conv = nn.Linear(in_fdim, out_fdim)
            self.out_bn = BatchNorm(out_fdim, bn_eps, bn_momentum)

    def _tail(self, agg):
        agg = F.relu(getattr(self, self.bn_name)(agg))
        if self.has_output:
            agg = F.relu(self.out_bn(self.output_conv(agg)))
        return agg


_POS_MID = {"one": 1, "xyz": 3, "distance": 1, "exp_-d": 1, "two_order": 9,
            "three_order": 18}


class PosPoolAgg(_Agg):
    """Parameter-free position-weighted pooling (+ output conv)."""

    def __init__(self, in_fdim: int, out_fdim: int, position_embedding: str = "sin_cos",
                 reduction: str = "mean", output_conv: bool = False,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-6):
        if position_embedding != "sin_cos" and position_embedding not in _POS_MID:
            raise ValueError(f"unknown position_embedding {position_embedding!r}")
        super().__init__(in_fdim, out_fdim, output_conv, bn_momentum, bn_eps)
        self.position_embedding = position_embedding
        self.reduction = reduction

    def _prior(self, rel, dist, fdim):
        pe = self.position_embedding
        if pe == "one":
            return torch.ones_like(dist)
        if pe == "xyz":
            return rel
        if pe == "distance":
            return dist
        if pe == "exp_-d":
            return torch.exp(-dist)
        if pe == "sin_cos":
            return _sincos_embedding(rel, fdim)
        x, y, z = rel[..., :1], rel[..., 1:2], rel[..., 2:3]
        second = [x * y, x * z, y * z, x * x, y * y, z * z]
        if pe == "two_order":
            return torch.cat([rel] + second, -1)
        third = [x ** 3, y ** 3, z ** 3, x * x * y, x * x * z, y * y * x,
                 y * y * z, z * z * x, z * z * y]
        return torch.cat([rel] + second + third, -1)

    def forward(self, p_query, p_support, nb_idx, features, radius):
        fdim = features.shape[-1]
        nb_f, _ = shadow_gather(features, nb_idx, fill=0.0)
        rel, dist, _, valid = _gather_geometry(p_query, p_support, nb_idx, radius)
        mid = fdim if self.position_embedding == "sin_cos" else _POS_MID[self.position_embedding]
        prior = self._prior(rel, dist, fdim)
        shared = max(fdim // mid, 1)
        b, m, k = nb_idx.shape
        fm = nb_f.reshape(b, m, k, mid, shared)
        agg = (prior[..., None] * fm).reshape(b, m, k, mid * shared)
        return self._tail(_reduce(agg, valid, self.reduction))


_LIF_WIDTH = {"dp": lambda f: 3, "df": lambda f: f, "dp_df": lambda f: 3 + f,
              "fj": lambda f: f, "dp_fj": lambda f: 3 + f, "fi_df": lambda f: 2 * f,
              "dp_fi_df": lambda f: 3 + 2 * f, "dp_fi_df_fj": lambda f: 3 + 3 * f}


def _local_input(lif, rel, nb_f):
    """The per-neighbour input of the weight / set MLP; the first neighbour
    is the centre (slot 0 of the self search)."""
    center = nb_f[:, :, :1, :]
    rel_f = nb_f - center
    center = center.expand_as(nb_f)
    parts = {"dp": [rel], "df": [rel_f], "dp_df": [rel, rel_f], "fj": [nb_f],
             "dp_fj": [rel, nb_f], "fi_df": [center, rel_f],
             "dp_fi_df": [rel, center, rel_f], "dp_fi_df_fj": [rel, center, rel_f, nb_f]}
    return torch.cat(parts[lif], -1)


class AdaptiveWeightAgg(_Agg):
    """MLP-predicted neighbour weights (the published operator: input 'dp',
    mean reduction, one shared channel, one fc, no softmax)."""

    def __init__(self, in_fdim: int, out_fdim: int, local_input_feature: str = "dp",
                 reduction: str = "mean", shared_channels: int = 1, fc_num: int = 1,
                 weight_softmax: str = "", output_conv: bool = False,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-6):
        if local_input_feature not in _LIF_WIDTH or local_input_feature == "dp_fi_df_fj":
            raise ValueError(f"unknown local_input_feature {local_input_feature!r}")
        super().__init__(in_fdim, out_fdim, output_conv, bn_momentum, bn_eps)
        self.local_input_feature = local_input_feature
        self.reduction = reduction
        self.fc_num = fc_num
        self.weight_softmax = weight_softmax
        self.shared = min(shared_channels, in_fdim)
        mid = in_fdim // self.shared
        d = _LIF_WIDTH[local_input_feature](in_fdim)
        for i in range(fc_num - 1):
            self.add_module(f"fc_{i}", nn.Linear(d, mid))
            d = mid
        self.add_module(f"fc_{fc_num}", nn.Linear(d, mid))

    def forward(self, p_query, p_support, nb_idx, features, radius):
        fdim = features.shape[-1]
        mid = fdim // self.shared
        b, m, k = nb_idx.shape
        nb_f, _ = shadow_gather(features, nb_idx, fill=0.0)
        rel, _, _, valid = _gather_geometry(p_query, p_support, nb_idx, radius)
        w = _local_input(self.local_input_feature, rel, nb_f)
        for i in range(self.fc_num - 1):
            w = F.relu(getattr(self, f"fc_{i}")(w))
        w = getattr(self, f"fc_{self.fc_num}")(w)
        if self.weight_softmax in ("mask", "dense", "sparse"):
            w = masked_softmax(w, valid[..., None], dim=2)
        elif self.weight_softmax == "unmask":
            w = torch.softmax(w, dim=2)
        fm = nb_f.reshape(b, m, k, mid, self.shared)
        agg = (w[..., None] * fm).reshape(b, m, k, fdim)
        return self._tail(_reduce(agg, valid, self.reduction))


class PointWiseMLPAgg(nn.Module):
    """Set MLP over [position | features] per neighbour, then a pool
    (PointNet++ style)."""

    def __init__(self, in_fdim: int, out_fdim: int, local_input_feature: str = "dp_fj",
                 fc_num: int = 2, reduction: str = "max", bn_momentum: float = 0.99,
                 bn_eps: float = 1e-6):
        super().__init__()
        if local_input_feature not in ("dp_fj", "fi_df", "dp_fi_df", "dp_fi_df_fj"):
            raise ValueError(f"unknown local_input_feature {local_input_feature!r}")
        self.local_input_feature = local_input_feature
        self.fc_num = fc_num
        self.reduction = reduction
        d = _LIF_WIDTH[local_input_feature](in_fdim)
        mfdim = max(in_fdim // 2, 9)
        for i in range(fc_num - 1):
            self.add_module(f"fc_{i}", nn.Linear(d, mfdim))
            self.add_module(f"bn_{i}", BatchNorm(mfdim, bn_eps, bn_momentum))
            d = mfdim
        self.add_module(f"fc_{fc_num}", nn.Linear(d, out_fdim))
        self.add_module(f"bn_{fc_num}", BatchNorm(out_fdim, bn_eps, bn_momentum))

    def forward(self, p_query, p_support, nb_idx, features, radius):
        nb_f, _ = shadow_gather(features, nb_idx, fill=0.0)
        rel, _, _, valid = _gather_geometry(p_query, p_support, nb_idx, radius)
        s = _local_input(self.local_input_feature, rel, nb_f)
        for i in list(range(self.fc_num - 1)) + [self.fc_num]:
            s = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"fc_{i}")(s)))
        s = s * valid[..., None].to(s.dtype)
        if self.reduction == "max":
            return s.amax(2)  # masked rows are 0, below every post-ReLU value
        return _reduce(s, valid, self.reduction)


def generate_kernel_points(radius: float, num_points: int = 15, seed: int = 0,
                           iters: int = 300) -> np.ndarray:
    """Kernel points in a ball, one pinned at the centre, spread by 300
    steps of repulsion in float64 and scaled to 0.66·radius in float32
    (the reference's construction, bit for bit)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (num_points, 3))
    pts[0] = 0.0
    for _ in range(iters):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = np.sum(diff**2, -1) + np.eye(num_points)
        force = (diff / (d2[..., None] ** 1.5 + 1e-9)).sum(1)
        pts += 0.01 * force
        pts[0] = 0.0
        norm = np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
        pts = np.where(norm > 1.0, pts / norm, pts)
    return (pts * 0.66 * radius).astype(np.float32)


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's xavier_uniform for a [fan_in, fan_out] parameter: uniform in
    ±√(6/(fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (weight.shape[0] + weight.shape[1]))
    with torch.no_grad():
        u = torch.empty(weight.shape, dtype=torch.float32)
        u.uniform_(-limit, limit, generator=generator)
        weight.copy_(u)
    return weight


class PseudoGridAgg(_Agg):
    """KPConv: linear (or gaussian, constant) influence of each neighbour
    on ``num_kernel_points`` fixed kernel points, a depthwise weight
    [P, C] per kernel point, summed (+ output conv). Shadow neighbours sit
    at 1e6 m and have no influence."""

    def __init__(self, in_fdim: int, out_fdim: int, radius: float,
                 density_parameter: float = 5.0, kp_extent: float = 1.0,
                 num_kernel_points: int = 15, kp_influence: str = "linear",
                 convolution_mode: str = "sum", output_conv: bool = False,
                 bn_momentum: float = 0.99, bn_eps: float = 1e-6):
        if kp_influence not in ("constant", "linear", "gaussian"):
            raise ValueError(f"unknown kp_influence {kp_influence!r}")
        if convolution_mode not in ("sum", "closest"):
            raise ValueError(f"unknown convolution_mode {convolution_mode!r}")
        super().__init__(in_fdim, out_fdim, output_conv, bn_momentum, bn_eps, bn_name="bn")
        self.extent = kp_extent * radius / density_parameter
        self.num_kernel_points = num_kernel_points
        self.kp_influence = kp_influence
        self.convolution_mode = convolution_mode
        kp = generate_kernel_points(1.5 * self.extent, num_kernel_points)
        self.register_buffer("kernel_points", torch.from_numpy(kp), persistent=False)
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_fdim))
        self.init_like_flax(torch.Generator().manual_seed(0))

    def init_like_flax(self, generator: torch.Generator):
        xavier_uniform_(self.weights, generator)

    def forward(self, p_query, p_support, nb_idx, features, radius):
        nb_p, _ = shadow_gather(p_support, nb_idx, fill=1e6)
        rel = nb_p - p_query[:, :, None, :]
        diff = rel[:, :, :, None, :] - self.kernel_points
        sq = (diff * diff).sum(-1)  # [B, M, K, P]
        if self.kp_influence == "constant":
            w = torch.ones_like(sq)
        elif self.kp_influence == "linear":
            w = torch.clamp_min(1.0 - torch.sqrt(sq) / self.extent, 0.0)
        else:
            sigma = self.extent * 0.3
            w = torch.exp(-sq / (2 * sigma ** 2))
        if self.convolution_mode == "closest":
            w = w * F.one_hot(sq.argmin(-1), self.num_kernel_points).to(w.dtype)
        nb_f, _ = shadow_gather(features, nb_idx, fill=0.0)
        weighted = torch.einsum("bmkp,bmkc->bmpc", w.float(), nb_f.float())
        out = (weighted * self.weights[None, None]).sum(2)
        return self._tail(out)


class IdentityAgg(nn.Module):
    """The centre's features (through a Dense with bias when the width
    changes), BN, ReLU."""

    def __init__(self, in_fdim: int, out_fdim: int, bn_momentum: float = 0.99,
                 bn_eps: float = 1e-6):
        super().__init__()
        self.has_output = in_fdim != out_fdim
        if self.has_output:
            self.output_conv = nn.Linear(in_fdim, out_fdim)
        self.bn = BatchNorm(out_fdim, bn_eps, bn_momentum)

    def forward(self, p_query, p_support, nb_idx, features, radius):
        center = shadow_gather(features, nb_idx[:, :, :1], fill=0.0)[0][:, :, 0, :]
        if self.has_output:
            center = self.output_conv(center)
        return F.relu(self.bn(center))


AGGREGATORS = {
    "pospool": PosPoolAgg,
    "adaptive_weight": AdaptiveWeightAgg,
    "pointwisemlp": PointWiseMLPAgg,
    "pseudo_grid": PseudoGridAgg,
    "identity": IdentityAgg,
}

"""Contrastive Boundary Learning (counterpart of
contrastboundary_tpu/losses/contrast.py).

The reference's whole option space of the stage loss: softnn or per-positive
InfoNCE (``nce``; with ``mask`` a flat mean over the positive terms) over the
contrast neighbours, l2, norml2, l2square or kl distances, argmax-equality
(``cnt``) or KL-threshold (``kl``) positives, the sub-scene labels inferred
soft, nst, max or recursively from stage to stage (recur, recurhard), the
``nn<k>`` prefix of the neighbours forced positive and ``rand<k>`` uniform
random rows as negatives, the ``S`` margin's separate positive term and the
``p<x>`` power. Each stage's loss is a masked mean × weight (across ranks,
this rank's share of the mean over the global batch, as the reference's
mean is under its batch-sharded jit). The reference's routes of
``cbl_stage_loss`` are chosen in its order:

- on the flagship's option point (softnn, l2 or norml2, cnt, no extra
  samples, no separate positive term, no mask, power 1) with
  window-relative neighbours (the sorted layout, or the natural one's tile
  contrast search, whose stages are first taken in the level's Morton
  order), the dense-window route (ops/cuda/cbl_dense.py), unless the
  environment has CBL_DENSE=off (the reference's switch,
  ops/pallas/cbl_dense.py:384);
- then, on the same option point, the fused v2 kernel
  (ops/cuda/cbl_tile2.py) when ContrastConfig.impl is 'auto' or 'pallas';
  there is no probe and no fallback here: the kernel launches, or its build
  or launch raises;
- otherwise plain tensor ops over the gathered [labels | features] rows:
  the tile route (ops/tile_gather.py) for window-relative neighbours, the
  global route (a row gather, the natural layout's) for global ones; the
  ``rand<k>`` rows are global rows, gathered apart on both.

The one refusal beyond the reference's: ``temperature=None`` (no DSL token
makes it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.gather import batch_gather, shadow_gather
from ..core.masking import EPS, INF, masked_global_mean
from ..ops.cuda.cbl_dense import cbl_dense_loss
from ..ops.cuda.cbl_tile2 import cbl_tile_softnn2
from ..ops.tile_gather import tile_window_gather
from ..parallel.mesh import global_mean, process_count, process_index
from ..utils import threefry

IMPLS = ("xla", "auto", "pallas")
CONTRASTS = ("softnn", "nce")
DISTS = ("l2", "l2square", "norml2", "kl")
POSITIVES = ("cnt", "kl")
PROJECTS = ("", "linear", "mlp", "mlp2")
FTYPES = ("latent", "logits", "probs", "f_out")
LABEL_INFERS = ("soft", "nst", "max", "recur", "recurhard")
_LOG_EPS = 1e-12


def _one_of(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"CBL {name} {value!r} is not one of {allowed}")


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """The reference's ContrastConfig, field for field with its defaults
    (the op-string segment ``contrast-Ua-softnn-latent-label-l2-w.1``):
    ``contrast`` softnn | nce; ``dist`` l2 | l2square | norml2 | kl;
    ``pos`` cnt (a neighbour is positive when its label argmax is the
    centre's) | kl (when KL(centre ‖ neighbour) < ``kl_threshold``);
    ``temperature`` (> 0); ``weight``; ``stages``; ``project`` the
    per-stage projection '' | linear | mlp | mlp2 and ``ftype`` the
    features the loss runs on, latent | logits | probs | f_out (both read
    by the model's MultiHead); ``label_infer`` soft | nst | max | recur |
    recurhard; ``extra_pos_nn`` the neighbours' prefix forced positive,
    ``extra_neg_rand`` uniform random rows as negatives; ``margin`` the
    ``m<x>`` token's value (stored; its 'S' sets ``separate_pos``, the
    negatives-only denominator); ``mask_mode`` nce's flat mean over the
    positive terms; ``power`` the per-point (per-term) loss's power;
    ``impl`` the kernel when the dense route is off on the flagship's
    option point: 'xla' (plain ops) or 'auto' / 'pallas' (the fused v2
    kernel)."""

    contrast: str = "softnn"
    dist: str = "l2"
    pos: str = "cnt"
    temperature: Optional[float] = 1.0
    weight: float = 0.1
    kl_threshold: float = 0.5
    stages: Tuple[int, ...] = (0, 1, 2, 3, 4)
    project: str = ""
    ftype: str = "latent"
    label_infer: str = "soft"
    extra_pos_nn: int = 0
    extra_neg_rand: int = 0
    margin: str = ""
    separate_pos: bool = False
    mask_mode: bool = False
    power: float = 1.0
    impl: str = "xla"

    def __post_init__(self):
        _one_of("contrast", self.contrast, CONTRASTS)
        _one_of("dist", self.dist, DISTS)
        _one_of("pos", self.pos, POSITIVES)
        _one_of("project", self.project, PROJECTS)
        _one_of("ftype", self.ftype, FTYPES)
        _one_of("label_infer", self.label_infer, LABEL_INFERS)
        _one_of("impl", self.impl, IMPLS)
        if self.temperature is None or not self.temperature > 0:
            raise ValueError(f"CBL temperature must be > 0, got {self.temperature}")
        for name in ("extra_pos_nn", "extra_neg_rand"):
            if getattr(self, name) < 0:
                raise ValueError(f"CBL {name} must be >= 0, got {getattr(self, name)}")

    @property
    def flagship_options(self) -> bool:
        """The option point of the CBL kernels (the reference's
        ``_flagship_options`` less its window-relative neighbours)."""
        return (self.contrast == "softnn" and self.dist in ("l2", "norml2")
                and self.pos == "cnt" and not self.extra_pos_nn and not self.extra_neg_rand
                and not self.separate_pos and not self.mask_mode and self.power == 1.0)


def dense_route() -> bool:
    """CBL_DENSE as the reference reads it: unset, 'auto' or 'on' take the
    dense-window route, 'off' skips it; its 'interpret' is a JAX test hook."""
    mode = os.environ.get("CBL_DENSE", "auto")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"CBL_DENSE={mode!r}: the port takes auto, on or off")
    return mode != "off"


def subscene_labels(labels0: torch.Tensor, subscene_idx: Optional[torch.Tensor],
                    num_classes: int, ignore_label: int = -1,
                    infer: str = "soft") -> torch.Tensor:
    """Labels [B, M, ncls] of a level from its kr nearest level-0 points
    (``subscene_idx`` [B, M, kr] global rows; None → level 0's own
    one-hot): 'soft' their mean one-hot, 'nst' the nearest one's one-hot,
    'max' the one-hot of the mean's argmax (a zero row where every
    neighbour is ignored). Ignored labels give a zero row."""
    valid = labels0 != ignore_label
    safe = torch.where(valid, labels0, 0).long()
    onehot = F.one_hot(safe, num_classes).float() * valid[..., None]
    if subscene_idx is None:
        return onehot
    idx = subscene_idx.long().clamp_max(labels0.shape[1] - 1)  # JAX clamps too
    if infer == "nst":
        return batch_gather(onehot, idx[..., 0])
    soft = batch_gather(onehot, idx).mean(-2)
    if infer == "max":
        return _hard(soft, num_classes)
    return soft


def _hard(dist: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The one-hot of the argmax of each row (the first maximum), a zero row
    where the row sums to 0."""
    any_valid = dist.sum(-1, keepdim=True) > 0
    return F.one_hot(dist.argmax(-1), num_classes).float() * any_valid


def _posmask_kl(label_soft, nb_label, threshold):
    """KL(label ‖ neighbour label) < threshold, the `kl` positives, with
    both distributions floored at 1e-12 inside the logs."""
    lab = label_soft[..., None, :]
    kl = (lab * (torch.log(torch.clamp_min(lab, _LOG_EPS))
                 - torch.log(torch.clamp_min(nb_label, _LOG_EPS)))).sum(-1)
    return kl < threshold


def _dist(cfg: ContrastConfig, f, nb_f):
    """Distance [B, M, K] between each row and its neighbours: l2 (ε inside
    the sqrt; norml2 on rows normalised before the gather), its square, or
    KL(centre ‖ neighbour) of the log-softmaxed rows."""
    if cfg.dist == "kl":
        lp = F.log_softmax(f, -1)[..., None, :]
        lq = F.log_softmax(nb_f, -1)
        return (torch.exp(lp) * (lp - lq)).sum(-1)
    d2 = ((f[..., None, :] - nb_f) ** 2).sum(-1)
    return d2 if cfg.dist == "l2square" else torch.sqrt(d2 + _LOG_EPS)


def _exps(cfg: ContrastConfig, dist, valid):
    """exp((−d − max)/T) over the valid slots (the max carries no
    gradient), 0 elsewhere: a slot that is not valid takes the exponent
    −50, so that a row with no valid slot stays finite."""
    vb = valid > 0
    d = -dist
    d = d - torch.where(vb, d, -INF).amax(-1, keepdim=True).detach()
    d = torch.where(vb, d / cfg.temperature, -50.0)
    return torch.exp(d) * valid


def _contrast_softnn(cfg: ContrastConfig, dist, posmask, valid):
    """−log(Σ_pos e / Σ e + ε) per row; with ``separate_pos`` the
    denominator is the negatives' sum."""
    e = _exps(cfg, dist, valid)
    pos = (e * posmask).sum(-1)
    under = (e * (valid - posmask)).sum(-1) if cfg.separate_pos else e.sum(-1)
    return -torch.log(pos / torch.clamp_min(under, EPS) + EPS)


def _nce_terms(cfg: ContrastConfig, dist, posmask, valid):
    """Per-slot InfoNCE terms [B, M, K] −log(e_k / under + ε) and the
    positive-term mask: under is Σ e over the valid slots, or with
    ``separate_pos`` e_k + Σ e over the negatives."""
    e = _exps(cfg, dist, valid)
    if cfg.separate_pos:
        under = e + (e * (valid - posmask)).sum(-1, keepdim=True)
    else:
        under = e.sum(-1, keepdim=True)
    return -torch.log(e / torch.clamp_min(under, EPS) + EPS), posmask * valid


def _gathered_loss(features, samples, label_soft, cfg, gather, shadow, rand_idx):
    """The reference's plain route (losses/contrast.py:338-357, 426-537 of
    the JAX package): the label pack (cnt: the 2 channels [argmax, any
    valid]; kl: the whole distribution) and the features gathered as one
    [B, M, K, n + C] tensor by ``gather`` over the sample slots (the
    neighbours, then the nn prefix), with the ``rand_idx`` rows gathered
    apart and appended; the masks (the prefix forced positive, the random
    rows negative), the distances, softnn or nce, the power and the masked
    mean. The label pack is data: the gather's gradient for its columns
    stops at the concatenation. ``shadow`` is the index of an invalid
    slot."""
    if cfg.pos == "cnt":
        center_arg = label_soft.argmax(-1)
        lab_pack = torch.stack([center_arg.float(), (label_soft.sum(-1) > 0).float()], -1)
    else:
        lab_pack = label_soft
    n_lab = lab_pack.shape[-1]
    fused = torch.cat([lab_pack, features.float()], -1)
    nb = gather(fused)
    valid = samples < shadow
    if rand_idx is not None:
        nb = torch.cat([nb, batch_gather(fused, rand_idx)], 2)
        valid = torch.cat([valid, torch.ones_like(rand_idx, dtype=torch.bool)], -1)
    nb_label, nb_feat = nb[..., :n_lab], nb[..., n_lab:]
    if cfg.pos == "cnt":
        valid = valid & (nb_label[..., 1] > 0.5)
        posmask = center_arg[..., None] == nb_label[..., 0].long()
    else:
        valid = valid & (nb_label.sum(-1) > 0)
        posmask = _posmask_kl(label_soft, nb_label, cfg.kl_threshold)
    k = samples.shape[-1] - cfg.extra_pos_nn  # the neighbours; then nn, then rand
    posmask[..., k:] = False
    posmask[..., k:k + cfg.extra_pos_nn] = True
    validf = valid.float()
    # the point mask (≥ 1 valid positive and ≥ 1 valid negative) from the
    # final posmask
    pos_cnt = (posmask * validf).sum(-1)
    valid_cnt = validf.sum(-1)
    center_valid = label_soft.sum(-1) > 0
    point_mask = (pos_cnt > 0) & (pos_cnt < valid_cnt) & center_valid
    posmask = posmask.float() * validf

    dist = _dist(cfg, features.float(), nb_feat)
    if cfg.contrast == "softnn":
        if cfg.mask_mode:  # the reference asserts this combination out
            raise ValueError("softnn does not support the 'mask' token")
        loss = _contrast_softnn(cfg, dist, posmask, validf)
    else:
        per_pos, pmask = _nce_terms(cfg, dist, posmask, validf)
        if cfg.mask_mode:  # a flat mean over every positive term
            if cfg.power != 1.0:
                per_pos = per_pos ** cfg.power
            w = pmask * point_mask[..., None]
            return global_mean((per_pos * w).sum(), w.sum()) * cfg.weight
        loss = (per_pos * pmask).sum(-1)
    if cfg.power != 1.0:
        loss = loss ** cfg.power
    return masked_global_mean(loss, point_mask) * cfg.weight


def rand_rows(key: threefry.Key, b: int, m: int, k: int, device) -> torch.Tensor:
    """The ``rand<k>`` rows [b, m, k] int64 of this rank: its b clouds' rows
    of ``jax.random.randint(key, (B, m, k), 0, m)`` over the global batch
    of B = b × ranks clouds (the reference draws the global batch's shape
    once under its batch-sharded jit)."""
    r0 = process_index() * b
    return threefry.randint(key, (b * process_count(), m, k), 0, m, device=device,
                            rows=(r0, r0 + b))


def cbl_stage_loss(features: torch.Tensor, contrast_idx: torch.Tensor,
                   label_soft: torch.Tensor, cfg: ContrastConfig,
                   local: Optional[Tuple[int, int]],
                   key: Optional[threefry.Key] = None) -> torch.Tensor:
    """CBL loss of one stage (× cfg.weight): features [B, M, C] and
    label_soft [B, M, ncls] in the pyramid's row order, contrast_idx
    [B, M, K]: window-relative with local = (tile, width) (the sorted
    layout, shadow tile·width), or global rows with local None (the natural
    layout, shadow M). ``key`` draws the ``rand<k>`` rows (required where
    cfg.extra_neg_rand is set)."""
    b, m = features.shape[:2]
    if cfg.dist == "norml2":
        features = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=-1, keepdim=True), EPS)
    label_soft = label_soft.float()
    if local is not None and cfg.flagship_options:
        tile, width = local
        window = (width - 1) // 2
        if dense_route():
            return cbl_dense_loss(features, label_soft, contrast_idx, float(cfg.temperature),
                                  tile, width, window, weight=cfg.weight)
        if cfg.impl in ("auto", "pallas"):
            loss_sum, mask_sum = cbl_tile_softnn2(
                features.float(), label_soft, contrast_idx, float(cfg.temperature), tile,
                width, window,
            )
            return global_mean(loss_sum.sum(), mask_sum.sum()) * cfg.weight
    samples = contrast_idx
    if cfg.extra_pos_nn:
        samples = torch.cat([contrast_idx, contrast_idx[..., :cfg.extra_pos_nn]], -1)
    rand_idx = None
    if cfg.extra_neg_rand:
        if key is None:
            raise ValueError("rand<k> negatives need a PRNG key")
        rand_idx = rand_rows(key, b, m, cfg.extra_neg_rand, features.device)
    if local is None:
        def gather(fused):
            return batch_gather(fused, torch.where(samples < m, samples, 0))

        shadow = m
    else:
        tile, width = local

        def gather(fused):
            return tile_window_gather(fused, samples, tile, width)

        shadow = tile * width
    return _gathered_loss(features, samples, label_soft, cfg, gather, shadow, rand_idx)


def recursive_labels(labels0: torch.Tensor, pyramid, num_classes: int, ignore_label: int,
                     hard: bool) -> list:
    """Each level's labels from the previous level's over its pooling
    neighbours (``pyramid.down_idx``, shadow slots read zeros): their mean
    ('recur'), or re-hardened at every level ('recurhard': the one-hot of
    the summed one-hots' argmax; an all-ignored row stays zero)."""
    lv = subscene_labels(labels0, None, num_classes, ignore_label)
    out = [lv]
    for l in range(1, len(pyramid.points)):
        nb, _ = shadow_gather(lv, pyramid.down_idx[l], fill=0.0)
        lv = _hard(nb.sum(-2), num_classes) if hard else nb.mean(-2)
        out.append(lv)
    return out


def cbl_loss(latents, pyramid, labels0: torch.Tensor, num_classes: int,
             cfg: ContrastConfig, ignore_label: int = -1,
             key: Optional[threefry.Key] = None):
    """Σ over the configured stages → (total, {"cbl_stage<i>": loss}).
    Stage i draws its random rows from ``fold_in(key, i)``. Where the
    natural layout's contrast search ran in tile mode
    (``pyramid.contrast_order[i]`` set) the stage's features and labels are
    first taken in that order, the rows its window-relative indices name;
    the loss is a masked mean, so nothing is put back."""
    losses = {}
    total = 0.0
    stages = [i for i in cfg.stages if i < len(latents) and latents[i] is not None]
    recur = None
    if cfg.label_infer in ("recur", "recurhard"):
        recur = recursive_labels(labels0, pyramid, num_classes, ignore_label,
                                 cfg.label_infer == "recurhard")
    for i in stages:
        if recur is not None:
            label_soft = recur[i]
        else:
            label_soft = subscene_labels(labels0, pyramid.subscene_idx[i], num_classes,
                                         ignore_label, cfg.label_infer)
        feats, order = latents[i], pyramid.contrast_order[i]
        if order is not None:
            feats, label_soft = batch_gather(feats, order), batch_gather(label_soft, order)
        ki = threefry.fold_in(key, i) if key is not None else None
        li = cbl_stage_loss(feats, pyramid.contrast_idx[i], label_soft, cfg,
                            pyramid.contrast_local[i], key=ki)
        losses[f"cbl_stage{i}"] = li
        total = total + li
    return total, losses

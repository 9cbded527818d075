"""Boundary evaluation protocol: B-IoU, bound/plain/ideal confusions, and
probability and feature distances across boundaries (counterpart of
contrastboundary_tpu/eval/boundary.py; host numpy, as there).

Definitions (per evaluation cloud):
  boundary(x) = point with >= 1 valid neighbour of a different valid label x;
  plain(x)    = all valid neighbours share the label;
  conf_bound  = confusion restricted to boundary points;
  conf_plain  = confusion restricted to plain points;
  conf_ideal  = confusion after forcing boundary predictions to ground truth
                (an upper bound showing how much error lives on boundaries);
  B-IoU       = |bound(label) & bound(pred)| / |bound(label) | bound(pred)|;
  prob/feature boundary distance = mean/max neighbour distance (kl for probs,
  l2/cos/norml2 for features), split into overall/pos/neg/bound/plain.
The neighbours are a KD-tree search capped at ``max_k`` with the radius as a
shadow mask (index N marks an empty slot).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from .metrics import metrics_from_confusion


def radius_neighbors_np(
    coord: np.ndarray, radius: float, max_k: int = 30
) -> np.ndarray:
    """Radius-capped KNN with shadow index N (reference radius-search
    semantics). coord [N,3] → idx [N, max_k] int64."""
    n = len(coord)
    tree = cKDTree(coord)
    k = min(max_k, n)
    d, idx = tree.query(coord, k=k)
    d, idx = np.atleast_2d(d), np.atleast_2d(idx)
    idx = np.where(d <= radius, idx, n)
    if k < max_k:
        idx = np.pad(idx, ((0, 0), (0, max_k - k)), constant_values=n)
    return idx


def boundary_mask_np(
    labels: np.ndarray,
    neighbor_idx: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
):
    """(bound, plain, (pos, neg)) masks. labels [N] int (<0 invalid),
    neighbor_idx [N,K] with shadow N. pos/neg are per-neighbor same/different
    valid-label masks (reference get_boundary_mask posneg=True)."""
    n = len(labels)
    pad = np.concatenate([labels, [-1]])
    nb = pad[np.minimum(neighbor_idx, n)]
    nb = np.where(neighbor_idx < n, nb, -1)
    valid_nb = nb >= 0
    center = labels[:, None]
    neq = (center != nb) & valid_nb & (center >= 0)
    eq = (center == nb) & valid_nb & (center >= 0)
    bound = neq.any(-1)
    plain = ((center == nb) | ~valid_nb).all(-1) & (labels >= 0)
    if valid_mask is not None:
        bound &= valid_mask
        plain &= valid_mask
    return bound, plain, (eq, neq)


def _neighbor_dist_np(x, neighbor_idx, kind):
    """Vectorized neighbor distance [N,K] with self excluded by the caller.
    x [N,d]; shadow rows contribute through the mask, not the values."""
    n = len(x)
    pad = np.concatenate([x, np.zeros_like(x[:1])])
    fn = pad[np.minimum(neighbor_idx, n)]  # [N,K,d]
    fc = x[:, None, :]
    if kind in ("cos", "norml2"):
        fc = fc / np.sqrt((fc**2).sum(-1, keepdims=True) + 1e-12)
        fn = fn / np.sqrt((fn**2).sum(-1, keepdims=True) + 1e-12)
    if kind in ("l2", "norml2"):
        return ((fc - fn) ** 2).sum(-1)
    if kind == "cos":
        return (fc * fn).sum(-1)
    if kind == "kl":
        return (fc * np.log(fc / (fn + 1e-12) + 1e-12)).sum(-1)
    raise ValueError(f"unknown dist {kind!r}")


class BoundaryEvaluator:
    """Accumulates the boundary protocol over evaluation clouds."""

    def __init__(self, num_classes: int, radius: float, max_k: int = 30):
        self.num_classes = num_classes
        self.radius = radius
        self.max_k = max_k
        c = num_classes
        self.conf = {
            f"conf_{which}_{m}": np.zeros((c, c), np.int64)
            for which in ("bound", "plain", "ideal")
            for m in ("label", "pred")
        }
        self.conf_total = np.zeros((c, c), np.int64)
        self.mask_i = 0
        self.mask_u = 0
        self.dist_acc: Dict[str, Dict[str, float]] = {}

    def _conf(self, a, b):
        c = self.num_classes
        m = (a >= 0) & (b >= 0)
        out = np.zeros((c * c,), np.int64)
        np.add.at(out, a[m] * c + b[m], 1)
        return out.reshape(c, c)

    def add_cloud(
        self,
        coord: np.ndarray,
        label: np.ndarray,
        prob: np.ndarray,
        features: Optional[Dict[str, np.ndarray]] = None,
        valid_mask: Optional[np.ndarray] = None,
    ):
        pred = prob.argmax(-1)
        nb = radius_neighbors_np(coord, self.radius, self.max_k)
        self.conf_total += self._conf(label, pred)

        masks = {}
        for name, lab in (("label", label), ("pred", pred)):
            bound, plain, posneg = boundary_mask_np(lab, nb, valid_mask)
            masks[name] = (bound, plain, posneg)
            self.conf[f"conf_bound_{name}"] += self._conf(
                label[bound], pred[bound]
            )
            self.conf[f"conf_plain_{name}"] += self._conf(
                label[plain], pred[plain]
            )
            pred_ideal = pred.copy()
            pred_ideal[bound] = label[bound]
            self.conf[f"conf_ideal_{name}"] += self._conf(label, pred_ideal)

        bl = masks["label"][0]
        bp = masks["pred"][0]
        self.mask_i += int((bl & bp).sum())
        self.mask_u += int((bl | bp).sum())

        # probability (and optional feature) distance across boundary
        sources = {"prob:kl": (prob, "kl")}
        for key, (x, kind) in list(sources.items()) + [
            (f"{k}:{d}", (v, d))
            for k, v in (features or {}).items()
            for d in ("l2", "cos", "norml2")
        ]:
            self._add_dist(key, x, kind, nb, masks)

    def _add_dist(self, key, x, kind, nb, masks):
        nb1 = nb[:, 1:]  # exclude self (column 0)
        n = len(x)
        valid = nb1 < n
        dist = _neighbor_dist_np(x, nb1, kind) * valid
        bound, plain, (eq, neq) = masks["label"]
        pos, neg = eq[:, 1:], neq[:, 1:]

        acc = self.dist_acc.setdefault(
            key,
            {k: 0.0 for k in (
                "overall", "overall_cnt", "pos", "pos_cnt", "neg", "neg_cnt",
                "bound", "bound_cnt", "plain", "plain_cnt",
                "boundmax", "plainmax",
            )},
        )
        acc["overall"] += float(dist[valid].sum())
        acc["overall_cnt"] += float(valid.sum())
        acc["pos"] += float(dist[pos].sum())
        acc["pos_cnt"] += float(pos.sum())
        acc["neg"] += float(dist[neg].sum())
        acc["neg_cnt"] += float(neg.sum())

        cnt = valid.sum(-1)
        mean_d = dist.sum(-1) / (cnt + 1e-12)
        max_d = dist.max(-1)
        acc["bound"] += float(mean_d[bound].sum())
        acc["bound_cnt"] += float(bound.sum())
        acc["plain"] += float(mean_d[plain].sum())
        acc["plain_cnt"] += float(plain.sum())
        acc["boundmax"] += float(max_d[bound].sum())
        acc["plainmax"] += float(max_d[plain].sum())

    def stat(self) -> dict:
        """Per-class boundary error tables — the reference's 'stat' extra op
        (tensorflow/utils/tester.py:800-830): for the total confusion and each
        bound/plain × label/pred confusion, per-class TP (diagonal), FN
        (row sum − TP) and FP (column sum − TP); plus the share of total
        error mass that lives on boundary points per boundary-mask source.
        """
        confs = {"total": self.conf_total}
        for mask_n in ("label", "pred"):
            for conf_n in ("bound", "plain"):
                confs[f"{mask_n}-{conf_n}"] = self.conf[
                    f"conf_{conf_n}_{mask_n}"
                ]
        out: dict = {}
        for name, conf in confs.items():
            tp = np.diagonal(conf, axis1=-2, axis2=-1).copy()
            out[name] = {
                "TP": tp,
                "FN": conf.sum(axis=-1) - tp,
                "FP": conf.sum(axis=-2) - tp,
            }
        err_total = int(self.conf_total.sum() - out["total"]["TP"].sum())
        out["err_total"] = err_total
        for mask_n in ("label", "pred"):
            b = confs[f"{mask_n}-bound"]
            p = confs[f"{mask_n}-plain"]
            err_bound = int(b.sum() - np.diagonal(b).sum())
            err_plain = int(p.sum() - np.diagonal(p).sum())
            out[f"err_bound_{mask_n}"] = err_bound
            out[f"err_plain_{mask_n}"] = err_plain
            out[f"pct_err_on_bound_{mask_n}"] = err_bound / max(err_total, 1)
        return out

    def results(self) -> dict:
        out: dict = {
            "B-IoU": self.mask_i / max(self.mask_u, 1),
        }
        for name, conf in self.conf.items():
            m = metrics_from_confusion(conf.astype(np.float64))
            out[name] = {k: m[k] for k in ("mIoU", "OA", "mACC")}
        for key, acc in self.dist_acc.items():
            out[f"dist_{key}"] = {
                "overall": acc["overall"] / max(acc["overall_cnt"], 1),
                "pos": acc["pos"] / max(acc["pos_cnt"], 1),
                "neg": acc["neg"] / max(acc["neg_cnt"], 1),
                "bound_mean": acc["bound"] / max(acc["bound_cnt"], 1),
                "plain_mean": acc["plain"] / max(acc["plain_cnt"], 1),
                "bound_max": acc["boundmax"] / max(acc["bound_cnt"], 1),
                "plain_max": acc["plainmax"] / max(acc["plain_cnt"], 1),
            }
        return out


def save_eval_h5(path: str, clouds: Sequence[dict]):
    """Persist per-cloud eval artifacts (probs/labels/coords) for offline
    re-analysis (reference save_split, tester.py:1007-1074)."""
    import h5py

    with h5py.File(path, "w") as f:
        for i, c in enumerate(clouds):
            g = f.create_group(f"cloud_{i}")
            for k, v in c.items():
                g.create_dataset(k, data=v)


def load_eval_h5(path: str) -> List[dict]:
    """Reload artifacts for offline boundary analysis (reference
    solve_extra_ops_from_file, tester.py:1077-1124)."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        for key in sorted(f.keys(), key=lambda s: int(s.split("_")[1])):
            out.append({k: np.asarray(v) for k, v in f[key].items()})
    return out

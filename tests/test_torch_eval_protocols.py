"""The port's eval protocols against the JAX package's on the CPU: Metrics'
ordering, voting with feature accumulators over two vote rounds, the
enumeration protocol, the boundary suite (radius neighbours, boundary masks,
BoundaryEvaluator's results and stat), the eval h5 files, and the slice as
a whole (run_enumerate_eval and run_voting_eval with the port's eval step
against JAX's evaluators driven by JAX's eval step, from the same weights).

Tolerances: everything the protocols compute on the host from the same
predictions is exact (the same numpy operations in the same order, float64
sums); the slice's accumulated logits and probs are within 1e-4 (the eval
step's tolerance), counts exact, argmax agreeing on >= 99.9% of points."""
import numpy as np
import pytest

from contrastboundary_tpu.eval import boundary as jb
from contrastboundary_tpu.eval.enumerate import EnumerateEvaluator as JaxEnumerate
from contrastboundary_tpu.eval.metrics import Metrics as JaxMetrics
from contrastboundary_tpu.eval.voting import VotingEvaluator as JaxVoting
from contrastboundary_tpu_torch.eval import boundary as tb
from contrastboundary_tpu_torch.eval.enumerate import EnumerateEvaluator
from contrastboundary_tpu_torch.eval.metrics import Metrics
from contrastboundary_tpu_torch.eval.run import analyze, run_enumerate_eval, run_voting_eval
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
import torch_eval_parity as ep

TOL = 1e-4


def quiet(*_):
    pass


def _logits(batch):
    """A deterministic function of a crop: class scores from height and
    colour."""
    p, f = batch["points"], batch["features"]
    return np.stack([np.sin(p[..., 2] * (c + 1)) + f[..., c % 3] for c in range(13)],
                    -1).astype(np.float32)


def _predict_with_features(batch):
    p = ep.softmax(_logits(batch)).astype(np.float32)
    pts, f = batch["points"], batch["features"]
    feats = {"latent0": np.concatenate([pts, f, pts * f], -1).astype(np.float32),
             "latent2": np.cos(pts * 3).astype(np.float32)}
    return p, feats


def assert_same(a, b, path="", exact=True):
    """Nested dicts, sequences, arrays and numbers equal (exact), or within
    TOL where ``exact`` is False."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}", exact)
    elif exact:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=path)


def test_metrics_order_and_scalar_str_match_jax():
    rows = [dict(mIoU=0.5, OA=0.8, mACC=0.6), dict(mIoU=0.5, OA=0.9, mACC=0.1),
            dict(mIoU=0.4, OA=0.99, mACC=0.9), dict(mIoU=0.5, OA=0.8, mACC=0.6, IoUs=[1, 2])]
    for order in (None, ("OA", "mIoU")):
        ms = [Metrics(r, order=order) for r in rows]
        js = [JaxMetrics(r, order=order) for r in rows]
        for i in range(len(rows)):
            assert ms[i].scalar_str() == js[i].scalar_str()
            for j in range(len(rows)):
                for op in ("__lt__", "__gt__", "__le__", "__ge__"):
                    assert getattr(ms[i], op)(ms[j]) == getattr(js[i], op)(js[j]), (i, j, op)
    assert max(Metrics(r) for r in rows[:3]) == rows[1]
    assert Metrics(mIoU=0.1) < Metrics(mIoU=0.1, OA=0.0)  # a missing key ranks lowest


@pytest.mark.parametrize("crop_mode", ["count", "radius"])
def test_voting_features_and_vote_rounds_match_jax(crop_mode):
    """(probs, features) from predict_fn, a first round, reset_potentials,
    a second round over the accumulated votes: probs, features, counts,
    potentials and metrics exact."""
    ds, jds = ep.datasets()
    kw = dict(num_classes=13, n_points=512, batch_size=2, voxel_size=ep.VOXEL,
              num_votes=0.5, crop_mode=crop_mode, in_radius=1.0)
    ev = VotingEvaluator(ds, _predict_with_features, **kw)
    jev = JaxVoting(jds, _predict_with_features, **kw)
    for steps in (3, 2):
        ev.reset_potentials()
        jev.reset_potentials()
        assert_same(ev.run(max_steps=steps), jev.run(max_steps=steps))
    assert ev.requests == 5
    for c, jc in zip(ev.clouds, jev.clouds):
        for k in ("probs", "counts", "potentials"):
            np.testing.assert_array_equal(getattr(c, k), getattr(jc, k), err_msg=k)
        assert_same(c.features, jc.features)
        assert sorted(c.features) == ["latent0", "latent2"]
        assert c.counts.max() >= 2  # points voted in both rounds


def test_enumerate_matches_jax():
    """Passes, the crop loop (the first pass holds more than n_points),
    padding and logits once per unique row: logits, counts and metrics
    exact; every point covered."""
    ds, jds = ep.datasets()
    kw = dict(num_classes=13, n_points=ep.N, batch_size=ep.B, voxel_size=ep.VOXEL,
              voxel_max=80000, seed=1)
    ev, jev = EnumerateEvaluator(ds, _logits, **kw), JaxEnumerate(jds, _logits, **kw)
    assert_same(ev.run(), jev.run())
    for a, b in zip((ev.logits, ev.pred_counts, ev.labels, ev.coords),
                    (jev.logits, jev.pred_counts, jev.labels, jev.coords)):
        for r in range(2):
            np.testing.assert_array_equal(a[r], b[r])
    assert all(c.min() > 0 for c in ev.pred_counts)
    # the crop loop cut the first room's passes; the second's were padded
    assert ev.parts[0] > ev.passes[0] and ev.parts[1] == ev.passes[1]
    assert ev.requests == sum(-(-p // ep.B) for p in ev.parts)


@pytest.mark.parametrize("n, max_k", [(600, 30), (20, 30)])
def test_radius_neighbors_and_boundary_masks_match_jax(n, max_k):
    rng = np.random.default_rng(n)
    coord = rng.random((n, 3)) * (1.0 if n > 100 else 0.2)
    idx = tb.radius_neighbors_np(coord, 0.1, max_k)
    np.testing.assert_array_equal(idx, jb.radius_neighbors_np(coord, 0.1, max_k))
    assert idx.shape == (n, max_k) and (idx == n).any()
    labels = rng.integers(-1, 4, n)
    valid = rng.random(n) > 0.1
    for vm in (None, valid):
        got, ref = tb.boundary_mask_np(labels, idx, vm), jb.boundary_mask_np(labels, idx, vm)
        for a, b in zip(got[:2] + got[2], ref[:2] + ref[2]):
            np.testing.assert_array_equal(a, b)


def _clouds(rng):
    out = []
    for n in (700, 450):
        coord = (rng.random((n, 3)) * [2.0, 2.0, 1.0]).astype(np.float32)
        label = np.where(coord[:, 0] > 1.0, 1, 0) + 2 * (coord[:, 2] > 0.5)
        label[rng.random(n) < 0.05] = -1
        logits = rng.standard_normal((n, 4)) + 3 * np.eye(4)[np.maximum(label, 0)]
        feats = {"latent0": rng.standard_normal((n, 8)).astype(np.float32),
                 "latent1": (coord @ rng.standard_normal((3, 5))).astype(np.float32)}
        out.append(dict(coord=coord, label=label.astype(np.int64),
                        prob=ep.softmax(logits).astype(np.float32), features=feats))
    return out


def test_boundary_evaluator_matches_jax():
    """B-IoU, the bound/plain/ideal confusions, the probability and feature
    distances across boundaries and the stat tables, over two clouds:
    exact."""
    clouds = _clouds(np.random.default_rng(0))
    bev, jbev = tb.BoundaryEvaluator(4, radius=0.12), jb.BoundaryEvaluator(4, radius=0.12)
    for c in clouds:
        for e in (bev, jbev):
            e.add_cloud(c["coord"], c["label"], c["prob"], features=c["features"])
    res = bev.results()
    assert_same(res, jbev.results())
    assert_same(bev.stat(), jbev.stat())
    assert 0 < res["B-IoU"] < 1 and len([k for k in res if k.startswith("dist_latent")]) == 6
    for kind in ("l2", "cos", "norml2"):
        assert np.isfinite(list(res[f"dist_latent1:{kind}"].values())).all()


def test_eval_h5_files_read_across_packages(tmp_path):
    clouds = [{k: c[k] for k in ("coord", "label", "prob")}
              for c in _clouds(np.random.default_rng(1))]
    for save, load, name in ((tb.save_eval_h5, jb.load_eval_h5, "port.h5"),
                             (jb.save_eval_h5, tb.load_eval_h5, "jax.h5")):
        save(str(tmp_path / name), clouds)
        back = load(str(tmp_path / name))
        assert len(back) == len(clouds)
        for a, b in zip(back, clouds):
            assert_same(a, b)
    # the offline re-analysis of a saved file: the live suite's numbers
    m = analyze(str(tmp_path / "port.h5"), num_classes=4, radius=0.12, log=quiet)
    bev = jb.BoundaryEvaluator(4, radius=0.12)
    for c in clouds:
        bev.add_cloud(c["coord"], c["label"], c["prob"])
    assert_same(m["boundary"], bev.results())
    assert_same(m["stat"], bev.stat())


def _agree(a, b) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def test_run_enumerate_eval_matches_jax():
    """The slice: run_enumerate_eval with the port's eval step on the CPU
    against JAX's EnumerateEvaluator driven by JAX's eval step."""
    ds, jds = ep.datasets()
    kw = dict(n_points=ep.N, batch_size=ep.B, voxel_size=ep.VOXEL, voxel_max=80000)
    ctx = {}
    m = run_enumerate_eval(ep.port_model(), ep.SPEC, ds, extra_ops="boundary-stat",
                           device="cpu", ctx=ctx, log=quiet, **kw)
    jev = JaxEnumerate(jds, lambda b: ep.jax_features(b)[0], 13, **kw)
    jm = jev.run()
    ev = ctx["evaluator"]
    for r in range(2):
        np.testing.assert_array_equal(ev.pred_counts[r], jev.pred_counts[r])
        np.testing.assert_allclose(ev.logits[r], jev.logits[r], rtol=TOL, atol=TOL)
        assert _agree(ev.logits[r], jev.logits[r]) >= 0.999
    assert abs(m["full"]["OA"] - jm["full"]["OA"]) <= 1e-3
    assert 0 <= m["boundary"]["B-IoU"] <= 1 and "pct_err_on_bound_label" in m["stat"]


def test_run_voting_eval_matches_jax():
    """The slice: run_voting_eval with the port's feature eval step against
    JAX's VotingEvaluator driven by JAX's (probs as the softmax of its
    logits, and its latents), then the boundary suite with features."""
    ds, jds = ep.datasets()
    kw = dict(n_points=ep.N, batch_size=ep.B, voxel_size=ep.VOXEL, num_votes=1.0)
    ctx = {}
    m = run_voting_eval(ep.port_model(), ep.SPEC, ds, extra_ops="boundary-stat-feature",
                        max_steps=2, device="cpu", ctx=ctx, log=quiet, **kw)

    def jax_predict(batch):
        logits, _, feats = ep.jax_features(batch)
        return ep.softmax(logits).astype(np.float32), feats

    jev = JaxVoting(jds, jax_predict, 13, **kw)
    jev.run(max_steps=2)
    assert ctx["evaluator"].requests == 2
    for c, jc in zip(ctx["evaluator"].clouds, jev.clouds):
        np.testing.assert_array_equal(c.counts, jc.counts)
        np.testing.assert_array_equal(c.potentials, jc.potentials)
        np.testing.assert_allclose(c.probs, jc.probs, rtol=0, atol=TOL)
        assert _agree(c.probs, jc.probs) >= 0.999
        assert sorted(c.features) == sorted(jc.features) == ["latent0", "latent1", "latent2"]
        for k in c.features:
            np.testing.assert_allclose(c.features[k], jc.features[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    br = m["boundary"]
    assert 0 <= br["B-IoU"] <= 1
    for k in ("latent0", "latent1", "latent2"):
        for kind in ("l2", "cos", "norml2"):
            assert np.isfinite(list(br[f"dist_{k}:{kind}"].values())).all()

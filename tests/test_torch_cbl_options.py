"""The CBL head's option space (losses/contrast.py) against the JAX package
on the CPU, at small shapes, inputs made with numpy from a seed: the stage
loss and its feature gradient on the global route (global rows, shadow M)
and on the window-relative route (the sorted layout's, shadow tile x width)
at every option point of the reference's ContrastConfig (softnn, nce, nce
with mask; l2, norml2, l2square, kl; the margins S, T and an inert one;
p2, p.5; nn4, rand8; the kl positives) with CBL_DENSE=off on both sides, so
that both take the plain gathered route; the sub-scene labels under each
label_infer, the recursive ones through cbl_loss; the random rows of
rand<k> (utils/threefry.py::randint) bit for bit; and the route each option
point takes: the dense kernels exactly where JAX's _flagship_options holds,
the v2 kernel exactly where JAX would probe its own.

Tolerances: loss rtol 1e-5 (float32 sums in another order); gradients rtol
1e-4, atol 1e-6; labels and random rows equal exactly.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import contrastboundary_tpu.losses.contrast as jax_contrast
import contrastboundary_tpu.ops.pallas.cbl_dense as jax_cbl_dense
import contrastboundary_tpu_torch.losses.contrast as port_contrast
from contrastboundary_tpu_torch.utils import threefry

F = np.float32
B, TILE, G, WIDTH, K, C, NCLS = 2, 16, 4, 3, 7, 6, 5
M, W = TILE * G, TILE * WIDTH

# option point → ContrastConfig fields (each against the flagship's defaults)
OPTIONS = {
    "softnn": {},
    "nce": dict(contrast="nce"),
    "nce_mask": dict(contrast="nce", mask_mode=True),
    "norml2": dict(dist="norml2"),
    "l2square": dict(dist="l2square"),
    "kl": dict(dist="kl"),
    "mS": dict(margin="S", separate_pos=True),
    "nce_mS": dict(contrast="nce", margin="S", separate_pos=True),
    "mT2": dict(margin="T2", temperature=2.0),
    "m.1": dict(margin=".1"),
    "p2": dict(power=2.0),
    "p.5": dict(power=0.5),
    "nn4": dict(extra_pos_nn=4),
    "rand8": dict(extra_neg_rand=8),
    "labelkl.5": dict(pos="kl", kl_threshold=0.5),
    # phase 47's first string's stage options, all together
    "a": dict(contrast="nce", dist="l2square", margin="S", separate_pos=True, mask_mode=True,
              extra_pos_nn=4, extra_neg_rand=8),
}


@pytest.fixture(autouse=True)
def plain_routes(monkeypatch):
    """CBL_DENSE=off on both sides (the reference's switch): the option
    points the kernels take run the plain gathered route too."""
    monkeypatch.setenv("CBL_DENSE", "off")


def _inputs(seed):
    """features [B, M, C], soft labels [B, M, NCLS] (the mean of three
    one-hots, 10% of the rows without a label), window-relative and global
    neighbour indices [B, M, K] with 10% shadow slots."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, M, C).astype(F)
    soft = np.eye(NCLS, dtype=F)[rng.randint(0, NCLS, (B, M, 3))].mean(-2)
    soft[rng.rand(B, M) < 0.1] = 0.0
    local = rng.randint(0, W, (B, M, K))
    local[rng.rand(B, M, K) < 0.1] = W
    glob = rng.randint(0, M, (B, M, K))
    glob[rng.rand(B, M, K) < 0.1] = M
    return feats, soft, local.astype(np.int32), glob.astype(np.int32)


def _configs(**kw):
    return jax_contrast.ContrastConfig(**kw), port_contrast.ContrastConfig(**kw)


def _stage(route, kw, seed=0):
    """(JAX loss, JAX gradient, port loss, port gradient) of one stage."""
    feats, soft, local, glob = _inputs(seed)
    jcfg, cfg = _configs(**kw)
    idx, loc = (local, (TILE, WIDTH)) if route == "tile" else (glob, None)
    jkey = jax.random.fold_in(jax.random.PRNGKey(13), 3)
    key = threefry.fold_in(threefry.prng_key(13), 3)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda f: jax_contrast.cbl_stage_loss(f, jnp.asarray(idx), jnp.asarray(soft), jcfg,
                                              key=jkey, local=loc)))(jnp.asarray(feats))
    x = torch.as_tensor(feats).requires_grad_(True)
    loss = port_contrast.cbl_stage_loss(x, torch.as_tensor(idx), torch.as_tensor(soft), cfg,
                                        loc, key=key)
    loss.backward()
    return float(jloss), np.asarray(jgrad), float(loss.detach()), x.grad.numpy()


# the options whose code differs by route (the sample sets gathered, the
# label pack's width) run on both; the others act after the gather
BOTH_ROUTES = ("softnn", "labelkl.5", "nn4", "rand8", "a")
STAGE_CASES = ([(name, "global") for name in sorted(OPTIONS)]
               + [(name, "tile") for name in BOTH_ROUTES])


@pytest.mark.parametrize("name,route", STAGE_CASES)
def test_stage_loss_and_gradient_match_jax(name, route):
    jloss, jgrad, loss, grad = _stage(route, OPTIONS[name])
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    ok = np.ones(grad.shape, bool)
    if name == "p.5":
        # a power below 1 at a row whose loss is 0 (outside the point mask)
        # has the derivative ∞, times its cotangent 0: NaN on the rows that
        # row names, in both packages; JAX's window route takes the gather's
        # transpose by one-hot matmuls, which carry each NaN to every row of
        # the window
        nan, jnan = np.isnan(grad), np.isnan(jgrad)
        assert nan.any() and not (nan & ~jnan).any()
        if route == "global":
            np.testing.assert_array_equal(nan, jnan)
        ok = ~jnan
    np.testing.assert_allclose(grad[ok], jgrad[ok], rtol=1e-4, atol=1e-6)


def test_softnn_refuses_the_mask_token():
    with pytest.raises(ValueError, match="mask"):
        _stage("global", dict(mask_mode=True))


@pytest.mark.parametrize("infer", ["soft", "nst", "max"])
def test_subscene_labels_equal_jax(infer):
    rng = np.random.RandomState(4)
    labels = rng.randint(-1, NCLS, (B, 200))
    idx = rng.randint(0, 200, (B, 50, 4)).astype(np.int32)
    idx[:, :3] = 200  # shadow rows: clamped to the last row, as XLA's gather
    ref = jax_contrast.subscene_labels(jnp.asarray(labels), jnp.asarray(idx), NCLS,
                                       infer=infer)
    got = port_contrast.subscene_labels(torch.as_tensor(labels), torch.as_tensor(idx), NCLS,
                                        infer=infer)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _pyramid(seed):
    """A two-level pyramid of global rows (64 and 16 points a cloud):
    pooling neighbours with shadow slots, sub-scene neighbours into level
    0, contrast neighbours with shadow slots."""
    rng = np.random.RandomState(seed)
    ms = (M, M // 4)
    down = [None, rng.randint(0, ms[0] + 1, (B, ms[1], 4))]
    sub = [None, rng.randint(0, ms[0], (B, ms[1], 4))]
    contrast = [rng.randint(0, m + 1, (B, m, K)) for m in ms]
    arrays = dict(down_idx=down, subscene_idx=sub, contrast_idx=contrast)
    nones = (None,) * 2

    def make(to):
        fields = {k: tuple(None if a is None else to(a.astype(np.int32)) for a in v)
                  for k, v in arrays.items()}
        return SimpleNamespace(points=nones, contrast_local=nones, contrast_order=nones,
                               **fields)

    feats = [rng.randn(B, m, C).astype(F) for m in ms]
    labels = rng.randint(-1, NCLS, (B, ms[0]))
    return make(jnp.asarray), make(torch.as_tensor), feats, labels


@pytest.mark.parametrize("infer", ["soft", "nst", "max", "recur", "recurhard"])
def test_cbl_loss_label_inference_matches_jax(infer):
    """cbl_loss over two stages with each label_infer (recur and recurhard
    over the pooling neighbours; recur with rand8, each stage's key folded
    from the step's): the recursive labels equal JAX's exactly, the stage
    losses and the total rtol 1e-5."""
    jpyr, pyr, feats, labels = _pyramid(6)
    rand = 8 if infer == "recur" else 0  # one case draws each stage's rows too
    jcfg, cfg = _configs(label_infer=infer, stages=(0, 1), extra_neg_rand=rand)
    jkey, key = jax.random.PRNGKey(13), threefry.prng_key(13)
    jtotal, jstages = jax.jit(lambda fs: jax_contrast.cbl_loss(
        fs, jpyr, jnp.asarray(labels), NCLS, jcfg, key=jkey))(tuple(jnp.asarray(f) for f in feats))
    total, stages = port_contrast.cbl_loss(tuple(torch.as_tensor(f) for f in feats), pyr,
                                           torch.as_tensor(labels), NCLS, cfg, key=key)
    assert set(stages) == set(jstages) == {"cbl_stage0", "cbl_stage1"}
    for k in stages:
        np.testing.assert_allclose(float(stages[k]), float(jstages[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    if infer.startswith("recur"):
        ref_hard = infer == "recurhard"
        got = port_contrast.recursive_labels(torch.as_tensor(labels), pyr, NCLS, -1, ref_hard)
        # JAX's recursion, as its cbl_loss runs it
        lv = jax_contrast.subscene_labels(jnp.asarray(labels), None, NCLS)
        for l in (1,):
            nb, _ = jax_contrast.shadow_gather(lv, jpyr.down_idx[l], fill=0.0)
            if ref_hard:
                s = jnp.sum(nb, -2)
                lv = jax.nn.one_hot(jnp.argmax(s, -1), NCLS) * (jnp.sum(s, -1, keepdims=True) > 0)
            else:
                lv = jnp.mean(nb, -2)
            np.testing.assert_array_equal(got[l].numpy(), np.asarray(lv))


@pytest.mark.parametrize("shape,hi", [((2, 64, 8), 64), ((3, 1000, 5), 65536), ((2, 7), 3)])
def test_rand_rows_equal_jax_randint(shape, hi):
    """randint's bits are jax.random.randint's; a rank's rows of a global
    draw (computed alone) are the global draw's rows."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(13), 5), 2)
    ref = np.asarray(jax.random.randint(key, shape, 0, hi, dtype=jnp.int32))
    tkey = threefry.fold_in(threefry.fold_in(threefry.prng_key(13), 5), 2)
    np.testing.assert_array_equal(threefry.randint(tkey, shape, 0, hi, device="cpu").numpy(),
                                  ref)
    for r in range(shape[0]):
        part = threefry.randint(tkey, shape, 0, hi, device="cpu", rows=(r, r + 1))
        np.testing.assert_array_equal(part.numpy(), ref[r:r + 1])
    # the trainer's rows at world size 1: the whole draw
    if len(shape) == 3:
        got = port_contrast.rand_rows(tkey, shape[0], shape[1], shape[2], "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax.random.randint(key, shape, 0, shape[1], dtype=jnp.int32)))


# the flagship's point, the options that keep it, and each option that leaves it
ROUTE_CASES = [{}, dict(dist="norml2"), dict(margin="T2", temperature=2.0), dict(margin=".1"),
               dict(label_infer="nst"), dict(project="mlp"), dict(ftype="f_out"),
               dict(contrast="nce"), dict(contrast="nce", mask_mode=True), dict(dist="l2square"),
               dict(dist="kl"), dict(margin="S", separate_pos=True), dict(power=2.0),
               dict(extra_pos_nn=4), dict(extra_neg_rand=8), dict(pos="kl")]


@pytest.mark.parametrize("local", [True, False])
def test_dense_and_v2_routes_exactly_where_jax_takes_its_kernels(monkeypatch, local):
    cases = ROUTE_CASES if local else ROUTE_CASES[:2]  # global rows: no kernel at all
    """With CBL_DENSE unset the port runs the dense kernels' wrapper exactly
    where JAX's _flagship_options holds (JAX then asks cbl_dense_ok, here
    recorded and answered False); with CBL_DENSE=off and impl='pallas' the
    v2 kernel's exactly where JAX would probe its own (_cbl_pallas_ok,
    recorded, False)."""
    feats, soft, lidx, gidx = _inputs(1)
    idx, loc = (lidx, (TILE, WIDTH)) if local else (gidx, None)
    seen = {"jax_dense": [], "jax_v2": [], "dense": [], "v2": []}

    def jax_dense_ok(*a, **kw):  # JAX asks it on the option point; CBL_DENSE=off answers no
        if os.environ.get("CBL_DENSE") != "off":
            seen["jax_dense"].append(case)
        return False

    def jax_v2_ok(*a, **kw):
        seen["jax_v2"].append(case)
        return False

    def recorder(name, fn):
        def run(*a, **kw):
            seen[name].append(case)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(jax_cbl_dense, "cbl_dense_ok", jax_dense_ok)
    monkeypatch.setattr(jax_contrast, "_cbl_pallas_ok", jax_v2_ok)
    monkeypatch.setattr(port_contrast, "cbl_dense_loss",
                        recorder("dense", port_contrast.cbl_dense_loss))
    monkeypatch.setattr(port_contrast, "cbl_tile_softnn2",
                        recorder("v2", port_contrast.cbl_tile_softnn2))
    jkey, key = jax.random.PRNGKey(0), threefry.prng_key(0)
    for case, kw in enumerate(cases):
        for dense, impl in ((None, "xla"), ("off", "pallas")):
            if dense is None:
                monkeypatch.delenv("CBL_DENSE", raising=False)
            else:
                monkeypatch.setenv("CBL_DENSE", dense)
            jcfg, cfg = _configs(**{**kw, "impl": impl})
            jax_contrast.cbl_stage_loss(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(soft),
                                        jcfg, key=jkey, local=loc)
            port_contrast.cbl_stage_loss(torch.as_tensor(feats), torch.as_tensor(idx),
                                         torch.as_tensor(soft), cfg, loc, key=key)
    assert seen["dense"] == seen["jax_dense"]
    assert seen["v2"] == seen["jax_v2"]
    flagship = [i for i, kw in enumerate(cases)
                if dataclasses.replace(port_contrast.ContrastConfig(), **kw).flagship_options]
    assert seen["dense"] == (flagship if local else [])
    assert len(flagship) == (7 if local else 2)

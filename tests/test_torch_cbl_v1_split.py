"""The v1 CBL stage-loss kernels (csrc/cbl_tile2.cu with V1, the split and
join kernels) as they split the work, rebuilt from the plain versions'
pieces (ops/cuda/cbl_tile.py, ops/cuda/cbl_tile2.py) and held to them on the
CPU, and their launch plan at every shape class the v2 kernels take. No card
and no JAX.

The split turns fused rows [soft labels | features] into v2's operands: meta
as row_meta writes it (the first maximum of the label columns, whether they
sum above 0) and the features padded with zero channels to 32, 64 or 128,
for any number of label columns. The forward combines a masked row's slots
as v1 does: the row's max over its valid slots first (an exact max over the
lanes' slots), then e and e·pos a slot and the sums in slot order, which is
the plain version's lanes 0-2 bit for bit. The backward is v2's on the
split's operands, its gradient written into the feature columns and zeros
into the label columns: the plain v1 backward is the plain v2 backward on
the split, bit for bit."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda.cbl_dense import row_meta

B, TILE, G, WIDTH, WINDOW = 2, 16, 4, 3, 1
M, W = TILE * G, TILE * WIDTH

# (C, M, K, tile) of the shape classes the v2 kernels take (chip_smoke.py's
# V2_SHAPES): C = 1 to 128, K = 1 to 300, M·K >= 2^23, tiles 128 to 4096
V2_CLASSES = [
    (1, 4096, 35, 256), (20, 4096, 35, 256), (33, 4096, 35, 256), (64, 4096, 1, 256),
    (128, 4096, 300, 256), (32, 4096, 300, 256), (32, 8192, 35, 128), (32, 8192, 35, 1024),
    (32, 32768, 300, 4096),
]


def _fused(ncls, c, seed, rows=M):
    """Soft labels in halves (ties among the label columns), 15% of the rows
    without a label, then the features."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, (B, rows, ncls)).astype(np.float32) / 2
    lab[rng.rand(B, rows) < 0.15] = 0.0
    feats = rng.randn(B, rows, c).astype(np.float32)
    return torch.as_tensor(np.concatenate([lab, feats], -1))


def _inputs(ncls, k, c=20, seed=0):
    rng = np.random.RandomState(seed + 100)
    li = rng.randint(0, W, (B, M, k)).astype(np.int32)
    li[rng.rand(B, M, k) < 0.1] = W  # shadow slots
    li[:, ::11] = W  # rows with no valid slot
    return _fused(ncls, c, seed), torch.as_tensor(li), torch.as_tensor(rng.randn(B).astype(np.float32))


@pytest.mark.parametrize("ncls", [1, 13, 40])
@pytest.mark.parametrize("c", [20, 33])
def test_split_is_row_meta_and_zero_padding(ncls, c):
    fused = _fused(ncls, c, seed=ncls + c, rows=512)
    lab = fused[..., :ncls]
    if ncls > 1:  # ties among the label columns, where the first maximum counts
        top = lab.max(-1, keepdim=True).values
        assert ((lab == top).sum(-1) > 1).any()
    features, meta = c1.split_plain(fused, ncls)
    np.testing.assert_array_equal(meta.numpy().view(np.int32), row_meta(lab).numpy().view(np.int32))
    assert features.shape[-1] == c2.padded_channels(c)
    np.testing.assert_array_equal(features.numpy(), F.pad(fused[..., ncls:], (0, features.shape[-1] - c)).numpy())
    assert (meta[..., 1] == 0).any() and (meta[..., 1] == 1).any()


@pytest.mark.parametrize("ncls,k", [(1, 6), (13, 20), (40, 70)])
def test_v1_plain_backward_is_v2_plain_backward_on_the_split(ncls, k):
    """With v1's statistics, as the kernel's forward writes them (the fill
    outside the mask) and as the plain forward does."""
    fused, li, g = _inputs(ncls, k, seed=k)
    stats = c1.cbl_tile_fwd_plain(fused, li, ncls, 0.5, TILE, WIDTH, WINDOW)
    filled = stats.clone()
    out = filled[..., 6] == 0
    filled[..., [0, 1, 2, 5]] = torch.where(out[..., None], 0.0, filled[..., [0, 1, 2, 5]])
    features, meta = c1.split_plain(fused, ncls)
    c = fused.shape[-1] - ncls
    for st in (stats, filled):
        got = c1.cbl_tile_bwd_plain(fused, li, st, g, ncls, 0.5, TILE, WIDTH, WINDOW)
        ref = c2.cbl_tile2_bwd_plain(features[..., :c], meta, li, st, g, 0.5, TILE, WIDTH, WINDOW)
        assert not got[..., :ncls].any()
        assert torch.isfinite(got).all()
        np.testing.assert_array_equal(got[..., ncls:].numpy().view(np.int32), ref.numpy().view(np.int32))
    if ncls > 1:
        assert (stats[..., 6] > 0).any() and g.abs().min() > 0


@pytest.mark.parametrize("k,temperature", [(6, 1.0), (35, 0.5), (70, 1.0)])
def test_v1_sums_over_lane_slots_equal_the_plain_stats(k, temperature):
    """Chunk c, lane l holds slots c·8S + 8j + l. The row's max is an exact
    max over every lane's valid slots (the chunk's own where one chunk holds
    K, else a pass over the chunks first); each slot's e and e·pos come
    from it, (0, 0) where the slot adds nothing; the 8 lanes walk the slots
    in order, j then l: p = p + e·pos, n = n + e. Every per-slot operation
    is the plain version's own torch op on [B, M]."""
    ncls = 4
    fused, li, _ = _inputs(ncls, k, c=32, seed=k + 1)
    ref = c1.cbl_tile_fwd_plain(fused, li, ncls, temperature, TILE, WIDTH, WINDOW)
    slot = c2._slots(*c1._split(fused, ncls), li, TILE, WIDTH, WINDOW)
    terms = [slot(kk)[:3] for kk in range(k)]  # (v, d, pos)
    s, nch = c2.lane_slots(k, 32)
    m_row = torch.full((B, M), -1e9)
    for kk in range(k):  # any order: the max is exact
        m_row = torch.maximum(m_row, torch.where(terms[kk][0] > 0, -terms[kk][1], -1e9))
    p, n, walked = torch.zeros(B, M), torch.zeros(B, M), []
    for c in range(nch):
        for j in range(s):
            for lane in range(c2.LANES):
                kk = c * c2.LANES * s + j * c2.LANES + lane
                if kk >= k:
                    continue
                vk, d, pos = terms[kk]
                e = torch.where(vk > 0, torch.exp((-d - m_row) / temperature) * vk, 0.0)
                p = p + e * pos
                n = n + e
                walked.append(kk)
    assert walked == list(range(k))
    mask = ref[..., 6] > 0
    assert mask.any()
    got = torch.stack([m_row, p, n], -1)
    np.testing.assert_array_equal(got[mask].numpy().view(np.int32),
                                  ref[..., :3][mask].numpy().view(np.int32))


@pytest.mark.parametrize("c,m,k,tile", V2_CLASSES)
@pytest.mark.parametrize("ncls", [13, 40])
def test_v1_plan_is_v2_plan_at_every_v2_shape_class(c, m, k, tile, ncls):
    """v1 takes v2's launch geometry on its C feature channels at every
    class v2 takes, with label columns beyond the previous kernel's cap of
    32 as well."""
    plan = c1.launch_plan(B, m, k, ncls + c, ncls, tile)
    assert plan == c2.bwd_plan(B, m, k, c, tile)
    assert plan.pass1 == c2.fwd_plan(B, m, k, c)
    assert plan.pass1.channels == c2.padded_channels(c)


def test_v1_refuses_the_widths_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="1 to 128"):
        c1.launch_plan(2, 256, 8, 13 + 129, 13, 64)
    with pytest.raises(ValueError, match="ncls"):
        c1.launch_plan(2, 256, 8, 45, 0, 64)
    with pytest.raises(ValueError, match="1 to 128"):  # no feature column
        c1.launch_plan(2, 256, 8, 13, 13, 64)
    with pytest.raises(ValueError, match="ncls"):
        c1.split_plain(torch.zeros(2, 8, 13), 13)


def test_v1_on_the_cpu_takes_40_label_columns_as_v2_does():
    """The wrappers run the plain versions on CPU tensors (no launch), and
    at 40 label columns v1 is v2's function on the same labels."""
    ncls, k = 40, 20
    fused, li, g = _inputs(ncls, k, seed=3)
    before = (c1.fwd_launches, c1.bwd_launches)
    fu = fused.clone().requires_grad_()
    loss1, mask1 = c1.cbl_tile_softnn(fu, li, ncls, 0.5, TILE, WIDTH, WINDOW)
    loss1.backward(g)
    ft = fused[..., ncls:].clone().requires_grad_()
    loss2, mask2 = c2.cbl_tile_softnn2(ft, fused[..., :ncls], li, 0.5, TILE, WIDTH, WINDOW)
    loss2.backward(g)
    assert (c1.fwd_launches, c1.bwd_launches) == before
    np.testing.assert_array_equal(mask1.numpy(), mask2.numpy())
    assert mask1.sum() > 0
    np.testing.assert_allclose(loss1.detach().numpy(), loss2.detach().numpy(), rtol=1e-5)
    assert not fu.grad[..., :ncls].any()
    scale = float(ft.grad.abs().max())
    np.testing.assert_allclose(fu.grad[..., ncls:].numpy(), ft.grad.numpy(), rtol=0, atol=1e-6 * scale)

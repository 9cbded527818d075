"""The CBL stats backward as the two passes of csrc/cbl_dense.cu compute it,
rebuilt in numpy float32 from the same inputs and held to the port's plain
version (ops/cuda/cbl_dense.py) on the CPU.

Pass 1 (a lane group a query row): each slot's coefficient cd in the plain
version's roundings with the forward's m̂, and dq = Σ cd·q − Σ cd·s summed in
slot order. Pass 2: each support row's sum of cd·(s − q) over the slots that
land on it, in ascending slot order, skipping cd = 0; dx = dq + that sum.
The scatter is bit for bit window_gather_bwd_plain of cd·(s − q) (CPU
index_add_ adds in slot order); cd is the plain version's up to exp's last
bit, with the same zeros; dq + the scatter is the plain backward to float
noise (dq sums in another order)."""
import numpy as np
import pytest
import torch

from contrastboundary_tpu_torch.ops.cuda import cbl_dense
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg

F = np.float32
B, TILE, G, WIDTH, WINDOW, K, C, NCLS = 2, 16, 4, 3, 1, 6, 32, 5
M, W = TILE * G, TILE * WIDTH


def _inputs(duplicates, shadows, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, M, C).astype(F)
    if duplicates:  # repeated rows: their d² cancels to 0 and hits the floor
        feats[:, 1::7] = feats[:, 0::7][:, : feats[:, 1::7].shape[1]]
    onehot = np.eye(NCLS, dtype=F)[rng.randint(0, NCLS, (B, M))]
    onehot[rng.rand(B, M) < 0.15] = 0.0  # rows without a label
    li = np.stack([rng.permutation(W)[:K] for _ in range(B * M)]).reshape(B, M, K).astype(np.int32)
    if shadows:
        li[rng.rand(B, M) < 0.1] = W
        li[rng.rand(B, M, K) < 0.1] = W
    g = rng.randn(B, M, 8).astype(F)
    g[rng.rand(B, M) < 0.2] = 0.0  # rows with no cotangent skip their slots
    return feats, cbl_dense.row_meta(torch.as_tensor(onehot)).numpy(), li, g


def _two_passes(feats, meta, li, stats, g, temperature):
    """(cd, lands, dq) of pass 1, in float32 scalars in the kernel's order."""
    inv_t = F(1.0) / F(temperature)
    starts = cbl_dense.self_window_starts(M, TILE, WIDTH, WINDOW)
    cd = np.zeros((B, M, K), F)
    lands = np.full((B, M, K), -1, np.int64)
    dq = np.zeros((B, M, C), F)
    for b in range(B):
        for q in range(M):
            dpos, dunder = g[b, q, 1], g[b, q, 2]
            if dpos == 0 and dunder == 0:
                continue
            qv, qa, mhat = feats[b, q], meta[b, q, 0], stats[b, q, 0]
            q2 = F(0)
            for c in range(C):
                q2 = F(q2 + qv[c] * qv[c])
            for kk in range(K):
                j = li[b, q, kk]
                if not 0 <= j < W:
                    continue
                sr = starts[q // TILE] * TILE + j
                mv = meta[b, sr, 1]
                if not mv > 0:
                    continue
                sv = feats[b, sr]
                s2 = qs = F(0)
                for c in range(C):
                    s2 = F(s2 + sv[c] * sv[c])
                    qs = F(qs + qv[c] * sv[c])
                sc = F(q2 + s2)
                d2 = max(F(sc - F(2) * qs), F(0))
                posmv = F(abs(F(qa - meta[b, sr, 0])) < 0.5) * mv
                dist = np.sqrt(F(d2 + F(1e-12)))
                e = F(np.exp(F(F(-dist - mhat) * inv_t)) * mv)
                coef = F(F(F(dpos * posmv) + dunder) * e) * -inv_t
                if d2 > F(F(1e-5) * sc):
                    cd[b, q, kk] = F(coef / dist)
                if cd[b, q, kk] != 0:
                    lands[b, q, kk] = sr
            cd_sum, acc = F(0), np.zeros(C, F)
            for kk in range(K):
                if cd[b, q, kk] != 0:
                    cd_sum = F(cd_sum + cd[b, q, kk])
                    acc = (acc + cd[b, q, kk] * feats[b, lands[b, q, kk]]).astype(F)
            dq[b, q] = (cd_sum * qv - acc).astype(F)
    return cd, lands, dq


def _scatter(feats, cd, lands):
    """Pass 2: each support row's sum of cd·(s − q) over the slots landing
    on it, in ascending slot order."""
    out = np.zeros((B, M, C), F)
    for b in range(B):
        for slot in range(M * K):
            q, kk = divmod(slot, K)
            r = lands[b, q, kk]
            if r >= 0:
                term = (cd[b, q, kk] * (feats[b, r] - feats[b, q]).astype(F)).astype(F)
                out[b, r] = (out[b, r] + term).astype(F)
    return out


def lands_of(li):
    """The support row of each valid slot (−1 for a shadow slot)."""
    starts = cbl_dense.self_window_starts(M, TILE, WIDTH, WINDOW)
    rows = np.repeat(starts * TILE, TILE)[None, :, None] + li
    return np.where((li >= 0) & (li < W), rows, -1)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("duplicates", [False, True])
def test_two_passes_match_the_plain_backward(duplicates, shadows, temperature):
    feats, meta, li, g = _inputs(duplicates, shadows, seed=3 if duplicates else 4)
    tf, tm, tl, tg_ = (torch.as_tensor(a) for a in (feats, meta, li, g))
    stats = cbl_dense.cbl_stats_fwd_plain(tf, tm, tl, temperature, TILE, WIDTH, WINDOW)
    cd_p, dq_p, t = cbl_dense.cbl_bwd_cd_plain(tf, tm, tl, stats, tg_, temperature, TILE, WIDTH, WINDOW)
    cd_p, dq_p = cd_p.numpy(), dq_p.numpy()

    cd, lands, dq = _two_passes(feats, meta, li, stats.numpy(), g, temperature)
    np.testing.assert_array_equal(cd != 0, cd_p != 0)  # members, floor, skipped rows
    assert (cd != 0).any() and (cd == 0).any()
    np.testing.assert_allclose(cd, cd_p, rtol=0, atol=1e-6 * np.abs(cd_p).max())
    np.testing.assert_allclose(dq, dq_p, rtol=0, atol=1e-5 * np.abs(dq_p).max())

    # every slot pass 2 adds lies in its support tile's slot range
    ranges = cbl_dense.scatter_slot_ranges(M, K, TILE, WIDTH, WINDOW)
    b_i, q_i, k_i = np.nonzero(lands >= 0)
    slots = q_i * K + k_i
    tiles = lands[b_i, q_i, k_i] // TILE
    assert np.all((ranges[tiles, 0] <= slots) & (slots < ranges[tiles, 1]))

    # the scatter of the plain version's cd, bit for bit the plain transpose
    scatter = _scatter(feats, cd_p, np.where(cd_p != 0, lands_of(li), -1))
    ds = torch.as_tensor(cd_p)[..., None] * (t["s"] - t["q"][:, :, None, :])
    ref = tg.window_gather_bwd_plain(ds, tl, t["starts"], TILE, WIDTH, M).numpy()
    np.testing.assert_array_equal(scatter.view(np.int32), ref.view(np.int32))

    dx = cbl_dense.cbl_stats_bwd_plain(tf, tm, tl, stats, tg_, temperature, TILE, WIDTH, WINDOW).numpy()
    np.testing.assert_allclose(dq + _scatter(feats, cd, lands), dx, rtol=0, atol=1e-5 * np.abs(dx).max())

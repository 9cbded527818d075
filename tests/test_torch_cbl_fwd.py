"""The CBL stats forward as csrc/cbl_dense.cu's cbl_stats_fwd_kernel splits
it, rebuilt in numpy float32 from the same inputs and held to the port's
plain version (ops/cuda/cbl_dense.py::cbl_stats_fwd_plain) on the CPU.

Eight lanes serve a query row; chunk c, lane l holds the slots
c·8·spl + l·spl + j (ops/cuda/cbl_dense.py::fwd_lane_slots). Each lane
computes its slots' d² once (|s|² of each window row summed once, the dot
product in channel order), m̂ is the max over the lanes, and the lanes add
their terms e·posmv, e, posmv, mv in turn, which is slot order. So d² and
the counts equal the plain version's bit for bit, m̂ too up to the last bit
of torch's CPU sqrt (which is not correctly rounded for about 0.6% of
float32 inputs; numpy's and the card's sqrtf are), the sums are within rel
1e-5 of it (it sums over the slots in another order), and every lane equals
a single walk over the slots in order (the previous kernel's design, a
thread per row walking its slots twice) bit for bit. A window that does not
fit in shared memory (ops/cuda/cbl_dense.py::fwd_plan gives 0 shared
bytes) is read through L2: each slot's |s|² is then summed beside its dot
product, in the same channel order, and every lane keeps the staged path's
bits."""
import numpy as np
import pytest
import torch

from contrastboundary_tpu_torch.ops.cuda import cbl_dense

F = np.float32
B, TILE, G, WIDTH, WINDOW, C, NCLS = 2, 32, 4, 3, 1, 32, 5
M, W = TILE * G, TILE * WIDTH
NEG = F(-1e9)


def _inputs(k, duplicates, shadows, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, M, C).astype(F)
    if duplicates:  # repeated rows: d² cancels to 0 (the clamp)
        feats[:, 1::7] = feats[:, 0::7][:, : feats[:, 1::7].shape[1]]
    onehot = np.eye(NCLS, dtype=F)[rng.randint(0, NCLS, (B, M))]
    onehot[rng.rand(B, M) < 0.15] = 0.0  # rows without a label
    li = np.stack([rng.permutation(W)[:k] for _ in range(B * M)]).reshape(B, M, k).astype(np.int32)
    if shadows:
        li[rng.rand(B, M) < 0.1] = W  # rows with only shadow slots
        li[rng.rand(B, M, k) < 0.1] = W
    return feats, cbl_dense.row_meta(torch.as_tensor(onehot)).numpy(), li


def _seq(a, b):
    """Σ_c a·b over the last axis in channel order, each op rounded."""
    acc = np.zeros(a.shape[:-1], F)
    for c in range(a.shape[-1]):
        acc = (acc + (a[..., c] * b[..., c]).astype(F)).astype(F)
    return acc


def _kernel_stats(feats, meta, li, temperature, staged=True):
    """stats [B, M, 8] as the kernel's lanes compute them, with the window
    staged (|s|² of each window row once) or read through L2 (|s|² of each
    slot's row with its dot product)."""
    k = li.shape[-1]
    inv_t = F(1.0) / F(temperature)
    starts = cbl_dense.self_window_starts(M, TILE, WIDTH, WINDOW)
    base = np.repeat(starts * TILE, TILE)  # each query's window start row
    rows = np.arange(B)[:, None, None] * M + base[None, :, None] + np.clip(li, 0, W - 1)
    in_win = (li >= 0) & (li < W)
    flat, fmeta = feats.reshape(B * M, C), meta.reshape(B * M, 8)
    s2_rows = _seq(flat, flat)  # each window row's |s|² once
    q2 = s2_rows.reshape(B, M)
    qa = meta[..., 0]
    s = flat[rows]
    qs = _seq(np.broadcast_to(feats[:, :, None, :], s.shape), s)
    sc = (q2[..., None] + (s2_rows[rows] if staged else _seq(s, s))).astype(F)
    d2 = np.maximum((sc - (F(2) * qs).astype(F)).astype(F), F(0))
    dist = np.sqrt((d2 + F(1e-12)).astype(F))
    mv = np.where(in_win & (fmeta[rows, 1] > 0), fmeta[rows, 1], F(0))
    pos = np.abs((qa[..., None] - fmeta[rows, 0]).astype(F)) < 0.5

    spl, nch = cbl_dense.fwd_lane_slots(k)
    lane_max = np.full((B, M, 8), NEG, F)
    for c in range(nch):
        for lane in range(8):
            for j in range(spl):
                kk = c * 8 * spl + lane * spl + j
                if kk < k:
                    cand = np.where(mv[..., kk] > 0, -dist[..., kk], NEG)
                    lane_max[..., lane] = np.maximum(lane_max[..., lane], cand)
    mhat = lane_max.max(-1)  # the xor-shuffle max over the 8 lanes
    arg = np.where(mv > 0, (((-dist) - mhat[..., None]).astype(F) * inv_t).astype(F), F(0))
    e = (np.exp(arg).astype(F) * mv).astype(F)
    posmv = (pos.astype(F) * mv).astype(F)
    acc = np.zeros((4, B, M), F)
    for c in range(nch):  # the lanes' turns
        for lane in range(8):
            for j in range(spl):
                kk = c * 8 * spl + lane * spl + j
                if kk >= k:
                    continue
                on = mv[..., kk] > 0
                for i, term in enumerate(((e[..., kk] * posmv[..., kk]).astype(F), e[..., kk],
                                          posmv[..., kk], mv[..., kk])):
                    acc[i] = np.where(on, (acc[i] + term).astype(F), acc[i])
    zero = np.zeros((B, M), F)
    stats = np.stack([mhat, acc[0], acc[1], acc[2], acc[3], zero, zero, zero], -1)
    return stats, d2, (dist, mv, pos, e)


def _slot_walk(dist, mv, pos, e):
    """One walk over each row's slots in order (a thread a row)."""
    k = dist.shape[-1]
    mhat = np.full((B, M), NEG, F)
    for kk in range(k):
        mhat = np.where(mv[..., kk] > 0, np.maximum(mhat, -dist[..., kk]), mhat)
    sums = np.zeros((4, B, M), F)
    for kk in range(k):
        on = mv[..., kk] > 0
        posmv = (pos[..., kk].astype(F) * mv[..., kk]).astype(F)
        for i, term in enumerate(((e[..., kk] * posmv).astype(F), e[..., kk], posmv, mv[..., kk])):
            sums[i] = np.where(on, (sums[i] + term).astype(F), sums[i])
    return mhat, sums


CASES = [(6, False, True), (23, True, True), (35, False, False), (35, True, True),
         (70, False, True)]


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("k,duplicates,shadows", CASES)
def test_lane_split_matches_the_plain_forward(k, duplicates, shadows, temperature):
    _check_lane_split(k, duplicates, shadows, temperature, staged=True)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("k,duplicates,shadows", CASES)
def test_lane_split_through_l2_matches_the_plain_forward(k, duplicates, shadows, temperature):
    _check_lane_split(k, duplicates, shadows, temperature, staged=False)


def _check_lane_split(k, duplicates, shadows, temperature, staged):
    feats, meta, li = _inputs(k, duplicates, shadows, seed=k + 7 * duplicates)
    got, d2, terms = _kernel_stats(feats, meta, li, temperature, staged)
    args = (torch.as_tensor(feats), torch.as_tensor(meta), torch.as_tensor(li), temperature,
            TILE, WIDTH, WINDOW)
    ref = cbl_dense.cbl_stats_fwd_plain(*args).numpy()
    # d², the counts and m̂ bit for bit (m̂ to torch's sqrt), the sums to float noise
    valid = terms[1] > 0
    ref_d2 = cbl_dense._slot_terms(*args)["d2"].numpy()
    np.testing.assert_array_equal(d2[valid].view(np.int32), ref_d2[valid].view(np.int32))
    np.testing.assert_array_max_ulp(got[..., 0], ref[..., 0], maxulp=1)
    np.testing.assert_array_equal(got[..., 3:], ref[..., 3:])
    np.testing.assert_allclose(got[..., 1:3], ref[..., 1:3], rtol=1e-5, atol=1e-7)
    assert (ref[..., 4] > 0).any() and (ref[..., 4] == 0).any() == shadows
    # every lane as a walk over the slots in order gives it
    mhat, sums = _slot_walk(*terms)
    np.testing.assert_array_equal(got[..., 0].view(np.int32), mhat.view(np.int32))
    np.testing.assert_array_equal(got[..., 1:5].view(np.int32),
                                  np.moveaxis(sums, 0, -1).view(np.int32))


def test_long_rows_go_in_chunks():
    """K > 64: chunks of 64 slots (8 a lane), the dists recomputed after the
    max; K ≤ 64: one chunk of ⌈K / 8⌉ slots a lane."""
    assert cbl_dense.fwd_lane_slots(6) == (1, 1)
    assert cbl_dense.fwd_lane_slots(35) == (5, 1)
    assert cbl_dense.fwd_lane_slots(23) == (3, 1)
    assert cbl_dense.fwd_lane_slots(64) == (8, 1)
    assert cbl_dense.fwd_lane_slots(70) == (8, 2)
    assert cbl_dense.fwd_lane_slots(256) == (8, 4)

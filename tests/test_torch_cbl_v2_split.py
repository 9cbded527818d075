"""The v2 CBL stage-loss kernels (csrc/cbl_tile2.cu, the scatter of
csrc/slot_scatter.cuh) as they split the work, rebuilt in numpy and torch
from the plain version's pieces (ops/cuda/cbl_tile2.py) and held to it on
the CPU, and their launch plans (::fwd_plan, ::bwd_plan) at every shape the
previous kernels took. No card and no JAX.

Forward: the label pass gives each row's counts and mask (lane l takes slots
l, l + 8, ...; 0/1 sums in any order); a lane's distance is one thread's sum
of 32 channel lanes and a halving tree, which is the plain version's
_lane_sum bit for bit; the running max before each slot is an exact prefix
max over the lanes' slots, and the sums are the online chain in slot order
with (1, 0, 0) for a slot that adds nothing, which equals the plain
version's lanes 0-2 on the rows of the mask bit for bit. Outside the mask
the kernel writes the fill (0, 0, 0), and the plain backward fed with it is
finite and unchanged. Backward: dq = the sum of coef (q - s) over a row's
slots in slot order, and the scatter adds coef (s - q) onto each support row
over the active rows' slots in ascending slot order (the ACTIVE scan of
each support tile, chunk by chunk of its query rows): dq plus that sum is
the plain backward bit for bit."""
import numpy as np
import pytest
import torch

from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda.cbl_dense import row_meta, self_window_starts

F = np.float32
B, TILE, G, WIDTH, WINDOW, NCLS = 2, 16, 4, 3, 1, 4
M, W = TILE * G, TILE * WIDTH
QUERY_CHUNK, MAX_VIRTUAL = 2048, 1 << 22  # csrc/slot_scatter.cuh
SCATTER_STATIC_SMEM = 11344  # the ACTIVE scatter's static shared bytes (ptxas)

# (C, M, K, tile, width, window) the plan must serve: the previous kernels
# took any C <= 128, any K and any tile and width with M % tile == 0
PLAN_SHAPES = [
    (1, 4096, 35, 256, 3, 1), (20, 4096, 35, 256, 3, 1), (33, 4096, 35, 256, 3, 1),
    (64, 4096, 1, 256, 3, 1), (128, 4096, 300, 256, 3, 1), (32, 8192, 35, 128, 5, 2),
    (32, 8192, 35, 1024, 1, 0), (32, 32768, 300, 4096, 4, 1), (32, 65536, 35, 256, 3, 1),
    (32, 256, 23, 256, 1, 0), (24, 96, 7, 96, 1, 0),
]


def _inputs(k, c=32, seed=0, shadows=True):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, M, c).astype(F)
    onehot = np.eye(NCLS, dtype=F)[rng.randint(0, NCLS, (B, M))]
    onehot[rng.rand(B, M) < 0.15] = 0.0  # rows without a label
    li = rng.randint(0, W, (B, M, k)).astype(np.int32)
    if shadows:
        li[rng.rand(B, M, k) < 0.1] = W
        li[:, ::11] = W  # rows with no valid slot
    g = rng.randn(B).astype(F)
    return (torch.as_tensor(feats), row_meta(torch.as_tensor(onehot)), torch.as_tensor(li),
            torch.as_tensor(g))


def _rows_of(li):
    """The window row (within the cloud) of every slot, −1 for a shadow."""
    starts = self_window_starts(M, TILE, WIDTH, WINDOW)
    rows = np.repeat(starts * TILE, TILE)[None, :, None] + li
    return np.where((li >= 0) & (li < W), rows, -1)


@pytest.mark.parametrize("c,m,k,tile,width,window", PLAN_SHAPES)
def test_plans_serve_every_shape_the_previous_kernels_took(c, m, k, tile, width, window):
    b = 2
    fwd = c2.fwd_plan(b, m, k, c)
    assert fwd.channels in (32, 64, 128) and c <= fwd.channels < 2 * max(c, 32)
    assert fwd.slots in ((3, 5, 8) if fwd.channels == 32 else (4,))
    assert fwd.chunks * c2.LANES * fwd.slots >= k > (fwd.chunks - 1) * c2.LANES * fwd.slots
    assert fwd.label_rows & (fwd.label_rows - 1) == 0
    assert c2.MIN_ROWS <= fwd.label_rows <= c2.MAX_LABEL_ROWS
    assert fwd.label_blocks * fwd.label_rows >= b * m > (fwd.label_blocks - 1) * fwd.label_rows
    assert c2.MIN_ROWS <= fwd.row_rows <= c2.MAX_ROW_ROWS <= 4 * c2.THREADS  # 4 a thread
    assert fwd.row_blocks * fwd.row_rows >= b * m > (fwd.row_blocks - 1) * fwd.row_rows
    # two blocks an SM, where the rows allow; every row dealt to one block
    assert fwd.row_blocks <= 2 * c2.SM_COUNT or fwd.row_rows == c2.MAX_ROW_ROWS
    assert fwd.row_rows % c2.DEAL == 0
    j = np.arange(fwd.row_rows)[None]
    dealt = (np.arange(fwd.row_blocks)[:, None] + j // c2.DEAL * fwd.row_blocks) * c2.DEAL + j % c2.DEAL
    assert np.array_equal(np.sort(dealt[dealt < b * m]), np.arange(b * m))
    bwd = c2.bwd_plan(b, m, k, c, tile)
    assert bwd.pass1 == fwd
    rows = bwd.scatter_rows
    assert rows & (rows - 1) == 0 and tile % rows == 0
    assert rows <= c2.scatter_max_rows(fwd.channels)
    blocks = bwd.scatter_grid[0] * b
    for min_blocks, min_rows in c2.SCATTER_STEPS:  # halved only where it has to
        assert blocks >= min_blocks or rows <= min_rows or rows == tile & -tile
    assert bwd.scatter_grid == ((m // tile) * (tile // rows), b)  # every support row once
    assert bwd.scatter_smem + SCATTER_STATIC_SMEM <= 227 * 1024
    # the ACTIVE scan's packing: a chunk's slots (v << 8) below 2^31
    assert min(QUERY_CHUNK, max(1, MAX_VIRTUAL // k)) * k < 1 << 23


def test_widths_beyond_the_previous_kernels_are_refused():
    with pytest.raises(ValueError, match="1 to 512"):
        c2.fwd_plan(2, 256, 8, 513)


def _lane_tree(diff2):
    """One thread's sum of the squares [..., C]: channel lane l' adds
    channels l', l' + 32, ... in turn (the kernel pads C to 32·CPL with
    zeros), then the 32 sums by a halving tree."""
    c = diff2.shape[-1]
    cpl = c2.padded_channels(c) // 32
    x = np.zeros(diff2.shape[:-1] + (32 * cpl,), F)
    x[..., :c] = diff2
    acc = x[..., :32].copy()
    for j in range(1, cpl):
        acc = (acc + x[..., 32 * j:32 * (j + 1)]).astype(F)
    h = 16
    while h:
        acc = (acc[..., :h] + acc[..., h:2 * h]).astype(F)
        h //= 2
    return acc[..., 0]


@pytest.mark.parametrize("c", [1, 20, 32, 33, 100, 128])
def test_thread_halving_tree_is_the_plain_lane_sum(c):
    rng = np.random.RandomState(c)
    diff = rng.randn(257, c).astype(F) * F(3)
    d2 = (diff * diff).astype(F)
    ref = c2._lane_sum(torch.as_tensor(d2)).numpy()
    np.testing.assert_array_equal(_lane_tree(d2).view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("k", [6, 20, 70])
def test_label_pass_counts_and_mask_equal_the_plain_version(k):
    """Lane l's counts over slots l, l + 8, ... (70 slots: two rounds of 64),
    summed over the 8 lanes by a shuffle tree."""
    feats, meta, li, _ = _inputs(k, seed=k)
    ref = c2.cbl_tile2_fwd_plain(feats, meta, li, 1.0, TILE, WIDTH, WINDOW).numpy()
    mt, rows = meta.numpy(), _rows_of(li.numpy())
    s_meta = np.where(rows[..., None] >= 0, mt[np.arange(B)[:, None, None], np.maximum(rows, 0)],
                      0.0)
    valid = s_meta[..., 1] > 0
    pos = valid & (np.abs(s_meta[..., 0] - mt[:, :, None, 0]) < 0.5)
    lanes_v = np.zeros((B, M, c2.LANES), F)
    lanes_p = np.zeros((B, M, c2.LANES), F)
    for kk in range(k):
        lanes_v[..., kk % c2.LANES] += np.where(valid[..., kk], s_meta[..., kk, 1], 0)
        lanes_p[..., kk % c2.LANES] += np.where(pos[..., kk], s_meta[..., kk, 1], 0)
    for h in (4, 2, 1):  # the xor butterfly, lane 0's view
        lanes_v = lanes_v[..., :h] + lanes_v[..., h:2 * h]
        lanes_p = lanes_p[..., :h] + lanes_p[..., h:2 * h]
    pc, vc = lanes_p[..., 0], lanes_v[..., 0]
    mask = (pc > 0) & (pc < vc) & (mt[..., 1] > 0)
    np.testing.assert_array_equal(pc, ref[..., 3])
    np.testing.assert_array_equal(vc, ref[..., 4])
    np.testing.assert_array_equal(mask.astype(F), ref[..., 6])
    assert mask.any() and not mask.all()


@pytest.mark.parametrize("k,temperature", [(6, 1.0), (20, 0.5), (70, 1.0)])
def test_online_chain_over_lane_slots_equals_the_plain_stats(k, temperature):
    """Chunk c, lane l holds slots c·8S + 8j + l; the running max before a
    slot is the carry of the earlier chunks' and j's maxima and the lanes
    before it; each slot's (rescale, e, e·pos) comes from it, (1, 0, 0)
    where the slot adds nothing; the chain walks the slots in order. Every
    per-slot operation is the plain version's own torch op on [B, M]."""
    feats, meta, li, _ = _inputs(k, seed=k + 1)
    ref = c2.cbl_tile2_fwd_plain(feats, meta, li, temperature, TILE, WIDTH, WINDOW)
    slot = c2._slots(feats, meta[..., 0], meta[..., 1], li, TILE, WIDTH, WINDOW)
    terms = [slot(kk)[:3] for kk in range(k)]  # (v, d, pos)
    s, nch = c2.lane_slots(k, 32)
    carry = torch.full((B, M), -1e9)
    p, n = torch.zeros(B, M), torch.zeros(B, M)
    for c in range(nch):
        for j in range(s):
            idx = [c * c2.LANES * s + j * c2.LANES + lane for lane in range(c2.LANES)]
            neg = [torch.where(terms[kk][0] > 0, -terms[kk][1], -1e9) if kk < k
                   else torch.full((B, M), -1e9) for kk in idx]
            before = carry
            steps = []
            for kk, v_neg in zip(idx, neg):  # the lanes' exclusive prefix
                steps.append((kk, before))
                before = torch.maximum(before, v_neg)
            carry = before
            for kk, m_prev in steps:
                if kk >= k:
                    continue
                vk, d, pos = terms[kk]
                ok = vk > 0
                m_new = torch.where(ok, torch.maximum(m_prev, -d), m_prev)
                scale = torch.where(ok, torch.exp((m_prev - m_new) / temperature), 1.0)
                e = torch.exp(torch.where(ok, (-d - m_new) / temperature, -50.0)) * vk
                p = p * scale + e * pos
                n = n * scale + e
    mask = ref[..., 6] > 0
    got = torch.stack([carry, p, n], -1)
    np.testing.assert_array_equal(got[mask].numpy().view(np.int32),
                                  ref[..., :3][mask].numpy().view(np.int32))


def _active_scan(active, k, tile, width, window, m):
    """The slots the ACTIVE scatter visits for each support tile, in its
    order: the active rows of the tile's query-row range, ascending, chunk
    by chunk, each row's K slots in turn (v = i K + k, i = v / K by the
    kernel's float product)."""
    g = m // tile
    starts = self_window_starts(m, tile, width, window)
    chunk = min(QUERY_CHUNK, max(1, MAX_VIRTUAL // k))
    inv_k = F(1) / F(k)
    seen = {}
    for st in range(g):
        lo = np.searchsorted(starts, st - width + 1, side="left") * tile
        hi = np.searchsorted(starts, st + 1, side="left") * tile
        order = []
        for q0 in range(lo, hi, chunk):
            qlist = [q for q in range(q0, min(q0 + chunk, hi)) if active[q]]
            v = np.arange(len(qlist) * k)
            qi = (v.astype(F) * inv_k).astype(np.int64)
            qi += (v >= (qi + 1) * k).astype(np.int64) - (v < qi * k)
            order += [(qlist[i], kk) for i, kk in zip(qi, v - qi * k)]
        seen[st] = order
    return seen


@pytest.mark.parametrize("k,seed", [(6, 0), (20, 1), (70, 2)])
def test_ordered_scatter_plus_dq_is_the_plain_backward(k, seed):
    feats, meta, li, g = _inputs(k, seed=seed)
    stats = c2.cbl_tile2_fwd_plain(feats, meta, li, 1.0, TILE, WIDTH, WINDOW)
    ref = c2.cbl_tile2_bwd_plain(feats, meta, li, stats, g, 1.0, TILE, WIDTH, WINDOW).numpy()
    coef, _ = c2.grad_coefs_plain(feats, meta[..., 0], meta[..., 1], li, stats, g, 1.0, TILE,
                                  WIDTH, WINDOW)
    coef, x, rows = coef.numpy(), feats.numpy(), _rows_of(li.numpy())
    active = (stats[..., 6].numpy() != 0) & (g.numpy()[:, None] != 0)
    lands = np.where((coef != 0) & active[..., None], rows, -1)
    assert (coef[~active] == 0).all()  # no other row has a term
    dx = np.zeros_like(x)
    for b in range(B):
        # pass 1: dq of each active row, its slots in order
        for q in np.nonzero(active[b])[0]:
            acc = np.zeros(x.shape[-1], F)
            for kk in range(k):
                if coef[b, q, kk] != 0:
                    gk = (coef[b, q, kk] * (x[b, q] - x[b, lands[b, q, kk]]).astype(F)).astype(F)
                    acc = (acc + gk).astype(F)
            dx[b, q] = acc
        # pass 2: each support tile's landing slots in the ACTIVE scan's order
        sums = np.zeros_like(x[b])
        for st, order in _active_scan(active[b], k, TILE, WIDTH, WINDOW, M).items():
            hits = [(q, kk) for q, kk in order if lands[b, q, kk] // TILE == st]
            slots = [q * k + kk for q, kk in hits]
            assert slots == sorted(slots)  # ascending slot order
            for q, kk in hits:
                s = lands[b, q, kk]
                term = (coef[b, q, kk] * (x[b, s] - x[b, q]).astype(F)).astype(F)
                sums[s] = (sums[s] + term).astype(F)
        dx[b] = (dx[b] + sums).astype(F)
        # every landing slot was visited once
        n_land = int((lands[b] >= 0).sum())
        assert sum(len([1 for q, kk in o if lands[b, q, kk] // TILE == st])
                   for st, o in _active_scan(active[b], k, TILE, WIDTH, WINDOW, M).items()) == n_land
    np.testing.assert_array_equal(dx.view(np.int32), ref.view(np.int32))


def test_plain_backward_fed_with_the_fill_is_finite_and_unchanged():
    """Outside the mask the kernel's forward writes (0, 0, 0) in lanes 0-2
    and 0 in lane 5; the plain backward on those statistics (as
    chip_smoke.py feeds it the kernel's) is finite and the same."""
    feats, meta, li, g = _inputs(20, seed=7)
    stats = c2.cbl_tile2_fwd_plain(feats, meta, li, 0.5, TILE, WIDTH, WINDOW)
    filled = stats.clone()
    out = filled[..., 6] == 0
    filled[..., [0, 1, 2, 5]] = torch.where(out[..., None], 0.0, filled[..., [0, 1, 2, 5]])
    assert out.any() and (stats[out][:, 0] != 0).any()
    ref = c2.cbl_tile2_bwd_plain(feats, meta, li, stats, g, 0.5, TILE, WIDTH, WINDOW)
    got = c2.cbl_tile2_bwd_plain(feats, meta, li, filled, g, 0.5, TILE, WIDTH, WINDOW)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("k", [300, 4096])
def test_active_scan_quotient_without_division(k):
    """The scatter's query row of a compacted slot v = i K + k is v / K by a
    float product, moved by one where it misses: exact for every v of a
    chunk (below 2^22 + K)."""
    n = np.arange(0, MAX_VIRTUAL + k, dtype=np.int64)
    inv = np.float32(1) / np.float32(k)
    q = (n.astype(np.float32) * inv).astype(np.int64)
    q = q + (n >= (q + 1) * k) - (n < q * k)
    np.testing.assert_array_equal(q, n // k)

"""The fused attention's backward as csrc/pt_attn.cu's pt_attn_bwd_kernel
decomposes it, rebuilt with torch float32 ops on the CPU and held to the
port's plain version (ops/cuda/pt_attn.py::pt_attn_bwd_plain).

The kernel takes tiles of ``rows`` query rows x all K slots
(ops/cuda/pt_attn.py::bwd_plan), block i taking tiles i, i + blocks, ...;
per tile it recomputes the forward once (r1 with the forward's roundings,
bvec as the shares' partials of Cs terms in order then the shares in order),
keeps the K scores w4 of each row and takes the softmax, S = Σ att·dα and
dw4 from them in one pass, then runs the tower backward as small matrix
products; the 12 parameter gradients are summed a block, and the blocks'
rows are summed by the caller. Held here: bvec bit for bit the plain
version's (``_terms``), and dq, dkv and the 12 gradients within 1e-4 of
their scale of the plain backward (db4, zero in exact arithmetic, against
dW4's scale), at C in {16, 32, 64}, K in {8, 16}, with shadow slots, for the
plan's geometry, for a small grid whose blocks take several tiles and whose
last tile is partial, and with a forced slot chunk (the path the plans take
at C = 512 with K > 16: only each slot's score, att and dalpha are kept for
all K; r1, bvec and r2 are recomputed a chunk at a time)."""
import numpy as np
import pytest
import torch

from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from contrastboundary_tpu_torch.ops.tile_gather import window_starts

TILE, G = 8, 5
M = TILE * G
NAMES = ["dq", "dkv", "dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2",
         "dW4", "db4"]


def _case(seed, k, width, c, shares=8):
    rng = np.random.RandomState(seed)
    cs = c // shares
    w_sz = TILE * width

    def a(shape, off=0.0):
        return torch.as_tensor((rng.randn(*shape) * 0.3 + off).astype(np.float32))

    params = [a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), 1.0), a((1, c)),
              a((c, cs)), a((1, cs)), a((1, cs), 1.0), a((1, cs)), a((cs, cs)), a((1, cs))]
    q = torch.as_tensor(rng.randn(2, M, c).astype(np.float32))
    kv = torch.as_tensor(rng.randn(2, M, 2 * c).astype(np.float32))
    rel = torch.as_tensor(rng.randn(2, M, k, 3).astype(np.float32))
    li = rng.randint(0, w_sz, (2, M, k)).astype(np.int32)
    starts = window_starts(G, width)
    li[:, :, 0] = (np.arange(M) - np.repeat(starts * TILE, TILE))[None]  # slot 0 = self
    li[:, ::3, -1] = w_sz  # shadow slots
    li[:, ::5, k // 2] = w_sz
    g = torch.as_tensor(rng.randn(2, M, c).astype(np.float32))
    return q, kv, rel, torch.as_tensor(li), torch.as_tensor(starts, dtype=torch.int32), params, g


def _tiled_backward(q, kv, rel, li, starts, tile, width, params, g, rows, blocks, chunk):
    """(dq, dkv, grads, bvec of every row) as the kernel's tiles compute
    them: pass A takes each chunk of ``chunk`` slots of every row through
    the recompute (dalpha, the scores), then the softmax runs over each
    row's K stored scores, and pass B recomputes each chunk's r1, bvec and
    r2 (where there is more than one chunk) for its tower backward; dq adds
    up over the chunks."""
    b, m, c = q.shape
    k = li.shape[-1]
    a1, c1, w2, b2, g1, h1, w3, b3, g2, h2, w4, b4 = params
    cs = w3.shape[-1]
    shares = c // cs
    n = b * m
    qf, gf, kvf = q.reshape(n, c), g.reshape(n, c), kv.reshape(n, 2 * c)
    lif, relf = li.reshape(n, k).long(), rel.reshape(n, k, 3)
    row0 = (torch.arange(n) // m) * m + starts.long()[(torch.arange(n) % m) // tile] * tile
    dq, dkv = torch.zeros(n, c), torch.zeros(n, 2 * c)
    bvec_all = torch.zeros(n, k, cs)
    tiles = -(-n // rows)
    chunks = [slice(k0, min(k0 + chunk, k)) for k0 in range(0, k, chunk)]
    block_grads = []
    for blk in range(blocks):
        acc = [torch.zeros_like(p) for p in params]
        for tl in range(blk, tiles, blocks):
            r = torch.arange(tl * rows, min((tl + 1) * rows, n))
            # P0: support rows, the PE tower's first layer (term by term)
            valid = (lif[r] >= 0) & (lif[r] < tile * width)
            src = torch.where(valid, row0[r, None] + lif[r], 0)
            rl = relf[r]
            pe1 = c1[0].expand(*rl.shape[:2], 3)
            for i in range(3):
                pe1 = pe1 + rl[..., i, None] * a1[i]
            rp = torch.relu(pe1)

            def recompute(ks):
                """P1-P2 of a chunk: pe, v, w_pre and r1 as the forward
                rounds them, bvec (the shares' partials in order, then the
                shares), r2."""
                pe = b2[0].expand(len(r), ks.stop - ks.start, c)
                for i in range(3):
                    pe = pe + rp[:, ks, i, None] * w2[i]
                kk = torch.where(valid[:, ks, None], kvf[src[:, ks], :c], 0.0)
                vv = torch.where(valid[:, ks, None], kvf[src[:, ks], c:], 0.0)
                wpre = (kk - qf[r, None]) + pe
                r1 = torch.relu(wpre * g1[0] + h1[0])
                bv = b3[0].expand(len(r), ks.stop - ks.start, cs)
                for p in range(shares):
                    part = torch.zeros(len(r), ks.stop - ks.start, cs)
                    for i in range(cs):
                        part = part + r1[..., p * cs + i, None] * w3[p * cs + i]
                    bv = bv + part
                return pe, vv, wpre, r1, bv, torch.relu(bv * g2[0] + h2[0])

            # pass A: dalpha and the scores of every slot, chunk by chunk
            dal, s4 = torch.zeros(len(r), k, cs), torch.zeros(len(r), k, cs)
            for ks in chunks:
                pe, vv, _, _, _, r2 = recompute(ks)
                dal[:, ks] = (gf[r, None] * (vv + pe)).reshape(len(r), -1, shares, cs).sum(2)
                s4[:, ks] = r2 @ w4 + b4[0]
            # P4: one softmax pass over the K stored scores
            s4 = s4.masked_fill(~valid[..., None], float("-inf"))
            e = torch.exp(s4 - s4.amax(1, keepdim=True))
            att = e / e.sum(1, keepdim=True)
            big_s = (att * dal).sum(1, keepdim=True)
            dw4_all = att * (dal - big_s)
            # pass B: P5 and P6 chunk by chunk
            dq_r = torch.zeros(len(r), c)
            for ks in chunks:
                _, _, wpre, r1, bv, r2 = recompute(ks)
                bvec_all[r, ks] = bv
                dw4, sr, sv = dw4_all[:, ks], src[:, ks], valid[:, ks]
                dcp = torch.where(r2 > 0, dw4 @ w4.T, 0.0)
                dbv = dcp * g2[0]
                da = torch.where(r1 > 0, dbv @ w3.T, 0.0)
                dwpre = da * g1[0]
                dq_r = dq_r - dwpre.sum(1)
                dvpe = att[:, ks].repeat(1, 1, shares) * gf[r, None]
                dkv.index_add_(0, sr[sv], torch.cat([dwpre, dvpe], -1)[sv])
                dpe = dwpre + dvpe
                dri = torch.where(pe1[:, ks] > 0, dpe @ w2.T, 0.0)
                flat = lambda x: x.reshape(-1, x.shape[-1])
                tile_grads = (flat(rl[:, ks]).T @ flat(dri), flat(dri).sum(0, keepdim=True),
                              flat(rp[:, ks]).T @ flat(dpe), flat(dpe).sum(0, keepdim=True),
                              flat(da * wpre).sum(0, keepdim=True), flat(da).sum(0, keepdim=True),
                              flat(r1).T @ flat(dbv), flat(dbv).sum(0, keepdim=True),
                              flat(dcp * bv).sum(0, keepdim=True), flat(dcp).sum(0, keepdim=True),
                              flat(r2).T @ flat(dw4), flat(dw4).sum(0, keepdim=True))
                acc = [x + y for x, y in zip(acc, tile_grads)]
            dq[r] = dq_r
        block_grads.append(acc)  # the block's packed row
    grads = [sum(rows_[i] for rows_ in block_grads) for i in range(12)]
    return dq.reshape(b, m, c), dkv.reshape(b, m, 2 * c), grads, bvec_all.reshape(b, m, k, cs)


@pytest.mark.parametrize("geometry", ["plan", "grid", "chunk"])
@pytest.mark.parametrize("k,width,c", [(8, 3, 16), (16, 3, 32), (8, 1, 32), (16, 3, 64)])
def test_tiled_backward_matches_the_plain_backward(k, width, c, geometry):
    q, kv, rel, li, starts, params, g = _case(k + c + width, k, width, c)
    b = q.shape[0]
    plan = pa.bwd_plan(b, M, k, c)
    rows, blocks, chunk = plan.rows, plan.blocks, plan.chunk
    assert chunk == k
    if geometry != "plan":  # blocks take several tiles; the last tile is partial
        rows, blocks = 32, 2
        assert rows % (plan.threads // c) == 0  # whole rows for each channel's group
        assert (b * M) % rows and -(-b * M // rows) > blocks
    if geometry == "chunk":  # chunks of 3 slots, the last one shorter
        chunk = 3
        assert k % chunk and pa.bwd_smem(c, rows, k, chunk) < pa.bwd_smem(c, rows, k, k)
    dq, dkv, grads, bvec = _tiled_backward(q, kv, rel, li, starts, TILE, width, params, g,
                                           rows, blocks, chunk)
    terms = pa._terms(q, kv, rel, li, starts, TILE, width, params)
    assert torch.equal(bvec.view(torch.int32), terms["bvec"].view(torch.int32))
    r_dq, r_dkv, r_grads = pa.pt_attn_bwd_plain(q, kv, rel, li, starts, TILE, width, params, g)
    got, ref = (dq, dkv, *grads), (r_dq, r_dkv, *r_grads)
    for name, x, y in zip(NAMES, got, ref):
        assert x.shape == y.shape, name
        scale = (ref[NAMES.index("dW4")] if name == "db4" else y).abs().max()
        err = (x - y).abs().max()
        assert err <= 1e-4 * scale, (name, float(err), float(scale))

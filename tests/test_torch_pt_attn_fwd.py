"""The fused attention's forward as csrc/pt_attn.cu's pt_attn_fwd_kernel
decomposes it, rebuilt with torch float32 ops on the CPU and held to the
port's plain version (ops/cuda/pt_attn.py::pt_attn_plain).

The kernel takes tiles of ``rows`` query rows x all K slots
(ops/cuda/pt_attn.py::fwd_plan), block i taking tiles i, i + blocks, ...;
per tile it runs the recompute it shares with the backward (the PE tower's
first layer term by term; r1 with the plain version's roundings; bvec as
the shares' partials of Cs terms in order, then the shares in order; r2;
the scores w4) over ``chunk`` slots of each row at a time, keeps every
slot's score, takes the softmax over each row's K stored scores, and sums
out = Σ att·(v + pe) a (row, channel), the PE tower's part through the
sums of att and att·relu(pe1) per (row, weight channel). The statistics are summed a block
(shadow slots included, rows past the last excluded), and the blocks' rows
by the caller. Held here: w_pre and bvec bit for bit the plain version's
(``_terms``), out and each row of s1 and s2 within 1e-5 of its scale, at C
in {16, 32, 64}, K in {8, 16}, with shadow slots, for the plan's geometry,
for a small grid whose blocks take several tiles and whose last tile is
partial, and with a forced slot chunk (the path the plans take at C = 512
with K > 16)."""
import pytest
import torch

from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from test_torch_pt_attn_bwd import TILE, M, _case


def _tiled_forward(q, kv, rel, li, starts, tile, width, params, rows, blocks, chunk):
    """(out, s1, s2, w_pre and bvec of every slot) as the kernel's tiles
    compute them."""
    b, m, c = q.shape
    k = li.shape[-1]
    a1, c1, w2, b2, g1, h1, w3, b3, g2, h2, w4, b4 = params
    cs = w3.shape[-1]
    shares = c // cs
    n = b * m
    qf, kvf = q.reshape(n, c), kv.reshape(n, 2 * c)
    lif, relf = li.reshape(n, k).long(), rel.reshape(n, k, 3)
    row0 = (torch.arange(n) // m) * m + starts.long()[(torch.arange(n) % m) // tile] * tile
    out = torch.zeros(n, c)
    wpre_all, bvec_all = torch.zeros(n, k, c), torch.zeros(n, k, cs)
    tiles = -(-n // rows)
    block_stats = []
    for blk in range(blocks):
        st1, st1q, st2, st2q = (torch.zeros(c), torch.zeros(c), torch.zeros(cs), torch.zeros(cs))
        for tl in range(blk, tiles, blocks):
            r = torch.arange(tl * rows, min((tl + 1) * rows, n))
            # P0: support rows, the PE tower's first layer (term by term)
            valid = (lif[r] >= 0) & (lif[r] < tile * width)
            src = torch.where(valid, row0[r, None] + lif[r], 0)
            pe1 = c1[0].expand(len(r), k, 3)
            for i in range(3):
                pe1 = pe1 + relf[r][..., i, None] * a1[i]
            rp = torch.relu(pe1)
            scores = torch.zeros(len(r), k, cs)
            for k0 in range(0, k, chunk):
                ks = slice(k0, min(k0 + chunk, k))
                # P1: w_pre and r1 as the plain version rounds them
                pe = b2[0].expand(len(r), ks.stop - k0, c)
                for i in range(3):
                    pe = pe + rp[:, ks, i, None] * w2[i]
                kk = torch.where(valid[:, ks, None], kvf[src[:, ks], :c], 0.0)
                wpre = (kk - qf[r, None]) + pe
                r1 = torch.relu(wpre * g1[0] + h1[0])
                # P2: bvec, the shares' partials in order, then the shares
                bv = b3[0].expand(len(r), ks.stop - k0, cs)
                for p in range(shares):
                    part = torch.zeros(len(r), ks.stop - k0, cs)
                    for i in range(cs):
                        part = part + r1[..., p * cs + i, None] * w3[p * cs + i]
                    bv = bv + part
                r2 = torch.relu(bv * g2[0] + h2[0])
                # P3: the chunk's scores, kept for every slot
                scores[:, ks] = r2 @ w4 + b4[0]
                wpre_all[r, ks], bvec_all[r, ks] = wpre, bv
                st1, st1q = st1 + wpre.sum((0, 1)), st1q + (wpre * wpre).sum((0, 1))
                st2, st2q = st2 + bv.sum((0, 1)), st2q + (bv * bv).sum((0, 1))
            # P4: the softmax over each row's K stored scores and, per (row,
            # weight channel), the sums of att and att·relu(pe1_i); then
            # out = Σ att·v + b2·Σ att + Σ_i W2[i]·Σ att·relu(pe1_i)
            scores = scores.masked_fill(~valid[..., None], float("-inf"))
            e = torch.exp(scores - scores.amax(1, keepdim=True))
            att = e / e.sum(1, keepdim=True)
            ap = torch.stack([att.sum(1)] + [(att * rp[..., i, None]).sum(1) for i in range(3)])
            ap = ap.repeat(1, 1, shares)  # channel p·Cs + j ← weight channel j
            vv = torch.where(valid[..., None], kvf[src, c:], 0.0)
            out[r] = ((att.repeat(1, 1, shares) * vv).sum(1) + b2[0] * ap[0] + w2[0] * ap[1]
                      + w2[1] * ap[2] + w2[2] * ap[3])
        block_stats.append(torch.cat([st1, st1q, st2, st2q]))  # the block's partial row
    sums = sum(block_stats) / (n * k)
    return (out.reshape(b, m, c), sums[: 2 * c].view(2, c), sums[2 * c:].view(2, cs),
            wpre_all.reshape(b, m, k, c), bvec_all.reshape(b, m, k, cs))


@pytest.mark.parametrize("geometry", ["plan", "grid", "chunk"])
@pytest.mark.parametrize("k,width,c", [(8, 3, 16), (16, 3, 32), (8, 1, 32), (16, 3, 64)])
def test_tiled_forward_matches_the_plain_forward(k, width, c, geometry):
    q, kv, rel, li, starts, params, _ = _case(k + c + width, k, width, c)
    b = q.shape[0]
    plan = pa.fwd_plan(b, M, k, c)
    rows, blocks, chunk = plan.rows, plan.blocks, plan.chunk
    if geometry != "plan":  # blocks take several tiles; the last tile is partial
        rows, blocks = 12, 3
        assert (b * M) % rows and -(-b * M // rows) > blocks
    if geometry == "chunk":  # chunks of 3 slots, the last one shorter
        chunk = 3
        assert k % chunk
    assert chunk == k or geometry == "chunk"
    out, s1, s2, wpre, bvec = _tiled_forward(q, kv, rel, li, starts, TILE, width, params, rows,
                                             blocks, chunk)
    terms = pa._terms(q, kv, rel, li, starts, TILE, width, params)
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(wpre), bits(terms["w_pre"]))
    assert torch.equal(bits(bvec), bits(terms["bvec"]))
    r_out, r_s1, r_s2 = pa.pt_attn_plain(q, kv, rel, li, starts, TILE, width, params)
    assert (out - r_out).abs().max() <= 1e-5 * r_out.abs().max()
    for got, ref in ((s1, r_s1), (s2, r_s2)):  # each row against its scale (means cancel)
        assert ((got - ref).abs().amax(1) <= 1e-5 * ref.abs().amax(1)).all()

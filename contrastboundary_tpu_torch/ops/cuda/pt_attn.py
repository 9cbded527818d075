"""Fused point-transformer attention under stale BatchNorm: kernel wrappers,
plain PyTorch versions and launch counters.

Replaces contrastboundary_tpu/ops/pallas/pt_attn.py::pt_attn, forward
(_fwd_call) and analytic backward (_bwd_call). The CUDA kernels are
``csrc/pt_attn.cu``; the design and the bound are noted there.

Contract (both versions): q [B, M, C] and kv [B, M, 2C] (linear_k | linear_v)
of one dtype, float32 or bfloat16, rel [B, M, K, 3] float32, li [B, M, K]
window-relative in the self
geometry (shadow slot = width·tile), starts int32 [M / tile] window starts in
tiles, and the 12 folded tower arrays ``params`` = (A1 [3, 3], c1 [1, 3],
W2 [3, C], b2 [1, C], g1 [1, C], h1 [1, C], W3 [C, Cs], b3 [1, Cs],
g2 [1, Cs], h2 [1, Cs], W4 [Cs, Cs], b4 [1, Cs]), Cs = C / shares. The
forward returns out [B, M, C] and the batch statistics s1 = [mean, mean of
squares] [2, C] of w_pre and s2 [2, Cs] of bvec, over all B·M·K slots (shadow
slots included). The backward takes g_out [B, M, C] to (dq, dkv, the 12
parameter gradients); rel and li take none. Everything is computed in
float32, bfloat16 q, kv and g_out widened exactly, as the TPU kernel does:
out is rounded once to q's dtype, dq and dkv are float32 sums cast to q's
and kv's dtype afterwards (where the reference casts them), and the
statistics and the 12 gradients are float32. The kernels are built for
shares = 8 (the flagship's share_planes) and C in {16, ..., 512}; the plain
versions take any shares.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...kernels import build
from . import tile_gather as _tg

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0
# the same launches by the dtype of q and kv
DTYPES = _tg.DTYPES
fwd_dtype_launches = dict.fromkeys(DTYPES.values(), 0)
bwd_dtype_launches = dict.fromkeys(DTYPES.values(), 0)

SHARES = 8  # share_planes the kernels are built for
CHANNELS = (16, 32, 64, 128, 256, 512)
SM_COUNT = 132  # H100 SXM
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on the H100
SMEM_PER_SM = 233472  # shared memory of an SM (each block also takes 1 KB)
TILE_FLOATS = 8192  # slot-rows x channels a tile holds at most


def _check(q, kv, rel, li, starts, tile, width, params):
    b, m, c = q.shape
    k = li.shape[-1]
    if (kv.shape != (b, m, 2 * c) or rel.shape != (b, m, k, 3) or li.shape != (b, m, k)
            or m % tile or starts.shape != (m // tile,) or width > m // tile):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)}, kv {tuple(kv.shape)}, rel {tuple(rel.shape)}, "
            f"li {tuple(li.shape)}, starts {tuple(starts.shape)} for tile={tile}, width={width}"
        )
    if len(params) != 12:
        raise ValueError(f"{len(params)} tower arrays, expected 12")
    cs = params[6].shape[-1]
    if c % cs:
        raise ValueError(f"C={c} is not a multiple of Cs={cs}")
    return b, m, c, k, cs


def _dot3(x, w, b):
    """b + Σ_i x[..., i]·w[i], one rounding per product and per sum, in the
    kernel's order."""
    out = b
    for i in range(3):
        out = out + x[..., i, None] * w[i]
    return out


def _terms(q, kv, rel, li, starts, tile, width, params):
    """Every per-slot activation of the function ([B, M, K, ·]). Up to the
    last ReLU input (c_) the values are rounded as the kernel rounds them,
    so both take the same side of every ReLU kink: the narrow products term
    by term, r1·W3 as the kernel splits it (group p of Cs inputs summed in
    order, then the shares partials in order)."""
    a1, c1, w2, b2, g1, h1, w3, b3, g2, h2, w4, b4 = (p.float() for p in params)
    c, cs = q.shape[-1], w3.shape[-1]
    shares = c // cs
    kv_nb = _tg.window_gather_plain(kv.float(), li, starts, tile, width)
    k_nb, v_nb = kv_nb[..., :c], kv_nb[..., c:]
    relf = rel.float()
    pe1 = _dot3(relf, a1, c1[0])
    r_pe = torch.relu(pe1)
    pe = _dot3(r_pe, w2, b2[0])
    w_pre = k_nb - q.float()[:, :, None, :] + pe
    a = w_pre * g1[0] + h1[0]
    r1 = torch.relu(a)
    r1s, w3s = r1.reshape(*r1.shape[:-1], shares, cs), w3.reshape(shares, cs, cs)
    part = r1s[..., 0, None] * w3s[:, 0]
    for i in range(1, cs):
        part = part + r1s[..., i, None] * w3s[:, i]  # [..., shares, Cs]
    bvec = b3[0]
    for p in range(shares):
        bvec = bvec + part[..., p, :]
    c_ = bvec * g2[0] + h2[0]
    r2 = torch.relu(c_)
    w4o = r2 @ w4 + b4[0]
    valid = (li >= 0) & (li < tile * width)
    return dict(rel=relf, v_nb=v_nb, pe1=pe1, r_pe=r_pe, pe=pe, w_pre=w_pre, a=a, r1=r1,
                bvec=bvec, c_=c_, r2=r2, w4o=w4o, valid=valid,
                w2=w2, g1=g1, w3=w3, g2=g2, w4=w4)


def pt_attn_plain(q, kv, rel, li, starts, tile: int, width: int, params):
    """Plain PyTorch forward, written from pt_attn.py::pt_attn_reference:
    the gathered neighbour rows and every tower activation as [B, M, K, ·]
    tensors, a masked softmax over K (−inf on shadow slots)."""
    b, m, c, k, cs = _check(q, kv, rel, li, starts, tile, width, params)
    t = _terms(q, kv, rel, li, starts, tile, width, params)
    cnt = b * m * k
    w_pre, bvec = t["w_pre"], t["bvec"]
    s1 = torch.stack([w_pre.sum((0, 1, 2)), (w_pre * w_pre).sum((0, 1, 2))]) / cnt
    s2 = torch.stack([bvec.sum((0, 1, 2)), (bvec * bvec).sum((0, 1, 2))]) / cnt
    att = torch.softmax(t["w4o"].masked_fill(~t["valid"][..., None], float("-inf")), dim=2)
    vpe = (t["v_nb"] + t["pe"]).reshape(b, m, k, c // cs, cs)
    out = (vpe * att[:, :, :, None, :]).sum(2).reshape(b, m, c)
    return out.to(q.dtype), s1, s2


def pt_attn_bwd_plain(q, kv, rel, li, starts, tile: int, width: int, params, g_out):
    """Plain PyTorch analytic backward, the algebra of the TPU kernel's
    backward passes (pt_attn.py::_bwd_kernel_b) as tensor ops: the softmax
    Jacobian through S = Σ_k α_k·dα_k, the folded tower backward, the
    positional tower fed by both of its consumers (w_pre and v + pe), and
    the dk|dv rows added onto their support rows."""
    b, m, c, k, cs = _check(q, kv, rel, li, starts, tile, width, params)
    shares = c // cs
    t = _terms(q, kv, rel, li, starts, tile, width, params)
    valid = t["valid"][..., None]
    w4o = t["w4o"].masked_fill(~valid, float("-inf"))
    e = torch.exp(w4o - w4o.amax(2, keepdim=True))
    alpha = e / e.sum(2, keepdim=True)  # [B, M, K, Cs]
    gout = g_out.float()[:, :, None, :]
    gv = gout * (t["v_nb"] + t["pe"])
    dalpha = gv.reshape(b, m, k, shares, cs).sum(3)
    s_sum = (alpha * dalpha).sum(2, keepdim=True)
    dw4 = alpha * (dalpha - s_sum)
    dvpe = alpha.repeat(1, 1, 1, shares) * gout  # channel si·Cs + j ← α_j

    def rowdot(x, y):  # Σ over slots of xᵀ·y
        return x.reshape(-1, x.shape[-1]).T @ y.reshape(-1, y.shape[-1])

    def colsum(x):
        return x.sum((0, 1, 2))[None, :]

    d_w4 = rowdot(t["r2"], dw4)
    d_b4 = colsum(dw4)
    dc_ = (dw4 @ t["w4"].T) * (t["c_"] > 0)
    d_g2, d_h2 = colsum(dc_ * t["bvec"]), colsum(dc_)
    dbv = dc_ * t["g2"][0]
    d_w3, d_b3 = rowdot(t["r1"], dbv), colsum(dbv)
    da = (dbv @ t["w3"].T) * (t["a"] > 0)
    d_g1, d_h1 = colsum(da * t["w_pre"]), colsum(da)
    dwpre = da * t["g1"][0]
    dq = -dwpre.sum(2)
    dkv = _tg.window_gather_bwd_plain(torch.cat([dwpre, dvpe], -1), li, starts, tile, width, m)
    dpe = dwpre + dvpe
    d_w2, d_b2 = rowdot(t["r_pe"], dpe), colsum(dpe)
    dr_pe = (dpe @ t["w2"].T) * (t["pe1"] > 0)
    d_a1, d_c1 = rowdot(t["rel"], dr_pe), colsum(dr_pe)
    return (dq.to(q.dtype), dkv.to(kv.dtype),
            (d_a1, d_c1, d_w2, d_b2, d_g1, d_h1, d_w3, d_b3, d_g2, d_h2, d_w4, d_b4))


def _cuda_args(q, kv, rel, li, starts, tile, width, params):
    """Contiguous operands on one CUDA device (q and kv float32 or bfloat16
    alike, rel and the tower arrays float32) and the geometry; raises on
    what the kernels do not take."""
    tensors = (q, kv, rel, li, starts) + tuple(params)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError(f"pt_attn: tensors on {sorted({str(x.device) for x in tensors})}")
    if q.dtype not in DTYPES or kv.dtype != q.dtype:
        raise TypeError(f"pt_attn takes float32 or bfloat16 q and kv alike, got {q.dtype}, "
                        f"{kv.dtype}")
    if any(x.dtype != torch.float32 for x in (rel,) + tuple(params)):
        raise TypeError("pt_attn takes float32 rel and tower arrays")
    b, m, c, k, cs = _check(q, kv, rel, li, starts, tile, width, params)
    if c not in CHANNELS or c != SHARES * cs:
        raise ValueError(f"pt_attn kernels take C in {CHANNELS} with shares {SHARES}; got C={c}, Cs={cs}")
    ops = [x.contiguous() for x in (q, kv, rel)]
    ops += [li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous()]
    ps = [p.contiguous() for p in params]
    return ops, ps, (b, m, k, c, cs)


def _pointers(ps):
    """The 12 arrays' device addresses as a host array of pointers."""
    return (ctypes.c_void_p * 12)(*(p.data_ptr() for p in ps))


def _prow(c: int, cs: int) -> list:
    """Sizes of the 12 gradients in the kernel's packed row, in order."""
    return [9, 3, 3 * c, c, c, c, c * cs, cs, cs, cs, cs * cs, cs]


class TilePlan(NamedTuple):
    blocks: int  # a persistent grid: block i takes tiles i, i + blocks, ...
    threads: int
    smem: int  # dynamic shared bytes
    rows: int  # query rows a tile (all K slots of each)
    chunk: int  # slots of each row the per-slot-row arrays hold at a time (K: one chunk)


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def tile_threads(c: int) -> int:
    """Threads of a block of either kernel: at least C (the output's and the
    backward's last phase's thread c owns channel c)."""
    return 512 if c // SHARES >= 64 else 256


def blocks_per_sm(c: int, kind: str) -> int:
    """Blocks an SM the forward or the backward is built for (their launch
    bounds, csrc/pt_attn.cu's ``Tiling::FWD_BLOCKS`` and ``BWD_BLOCKS``;
    tests/test_torch_kernel_plans.py holds the two equal)."""
    return 1 if c // SHARES >= 64 else (3 if kind == "fwd" else 2)


def bwd_stash(c: int) -> bool:
    """Whether the backward keeps w_pre in shared memory (its last phase then
    reads no global memory): below C = 512."""
    return c // SHARES <= 32


def _image_floats(c: int) -> int:
    """Floats of the parameter image (W3 and W4 rows padded to an odd number
    of vectors)."""
    cs = c // SHARES
    vj = min(cs, 4)
    nq = cs // vj
    ws = (nq if nq % 2 else nq + 1) * vj
    return 16 + 6 * c + c * ws + 4 * _round4(cs) + cs * ws


def fwd_smem(c: int, rows: int, k: int, chunk: int) -> int:
    """Dynamic shared bytes of a forward block (csrc/pt_attn.cu::
    fwd_smem_floats): the parameter image; r1 [rows·chunk, C + 1] and r2
    [rows·chunk, Cs] of a chunk; the scores [rows·K, Cs]; the PE tower's
    first layer and the support rows of every slot-row; the tile's q rows;
    per (row, weight channel) the sums of att and att·relu(pe1); at the end
    the threads' partial statistics."""
    cs = c // SHARES
    ns, nc = rows * k, rows * chunk
    t = tile_threads(c)
    tile = (_image_floats(c) + _round4(nc * (c + 1)) + _round4(nc * cs) + _round4(ns * cs)
            + _round4(3 * ns) + _round4(ns) + _round4(rows * c) + 4 * rows * cs)
    stats = 2 * c * (t // cs) + 2 * cs * (t // (cs // min(cs, 4)))
    return 4 * max(tile, stats)


def bwd_smem(c: int, rows: int, k: int, chunk: int) -> int:
    """Dynamic shared bytes of a backward block (csrc/pt_attn.cu::
    bwd_smem_floats): the parameter image; r1 [rows·chunk, C + 1] (and,
    where it stashes it, w_pre) and bvec, r2, dbv [rows·chunk, Cs] of a
    chunk; the scores (then att) and dalpha (then dw4) [rows·K, Cs]; rel, the
    PE tower's first layer and the support rows of every slot-row; the
    tile's q and g rows; at the end the packed gradient row and the warps'
    partial sums of dA1 and dc1."""
    cs = c // SHARES
    ns, nc = rows * k, rows * chunk
    per_row = _round4(nc * (c + 1)) * (2 if bwd_stash(c) else 1)
    tile = (_image_floats(c) + per_row + 3 * _round4(nc * cs) + 2 * _round4(ns * cs)
            + 2 * _round4(3 * ns) + _round4(ns) + 2 * _round4(rows * c))
    end = _round4(sum(_prow(c, cs))) + 12 * (tile_threads(c) // 32)
    return 4 * max(tile, end)


def _tile_plan(b, m, k, c, kind, min_rows) -> TilePlan:
    """A tile is ``rows`` query rows with all K slots: the largest power of
    two with rows·K·C <= 8192 (at least min_rows), halved (down to
    min_rows) while the blocks an SM is built for would not fit in its
    shared memory. Where even that tile's slot-rows do not fit in a block's
    shared memory, its per-slot-row arrays take ``chunk`` slots of each row
    at a time: the fewest chunks that fit, of equal size. The grid is
    persistent: as many blocks as fit on the card at once, at most one a
    tile."""
    what, smem_of = f"pt_attn_{kind}", (fwd_smem if kind == "fwd" else bwd_smem)
    if c not in CHANNELS:
        raise ValueError(f"{what} takes C in {CHANNELS}; got {c}")
    threads, per_sm = tile_threads(c), blocks_per_sm(c, kind)
    rows = max(1, TILE_FLOATS // (k * c))
    rows = max(1 << (rows.bit_length() - 1), min_rows)
    while rows > min_rows and per_sm * (smem_of(c, rows, k, k) + 1024) > SMEM_PER_SM:
        rows //= 2
    chunk = k
    if smem_of(c, rows, k, k) > SMEM_LIMIT:
        fits = [kc for kc in range(k, 0, -1) if smem_of(c, rows, k, kc) <= SMEM_LIMIT]
        if not fits:
            raise ValueError(f"{what} tile of {rows} rows x K={k} does not fit in shared memory")
        chunk = -(-k // -(-k // fits[0]))
    smem = smem_of(c, rows, k, chunk)
    per_sm = min(per_sm, SMEM_PER_SM // (smem + 1024))
    tiles = -(-b * m // rows)
    return TilePlan(min(tiles, SM_COUNT * per_sm), threads, smem, rows, chunk)


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, m: int, k: int, c: int) -> TilePlan:
    """Launch geometry of the forward (``_tile_plan``, tiles of any number
    of rows)."""
    return _tile_plan(b, m, k, c, "fwd", 1)


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, m: int, k: int, c: int) -> TilePlan:
    """Launch geometry of the backward (``_tile_plan``, at least threads / C
    rows a tile, so that each channel's thread group of the last phase gets
    whole rows)."""
    return _tile_plan(b, m, k, c, "bwd", tile_threads(c) // c)


def pt_attn_fwd(q, kv, rel, li, starts, tile: int, width: int, params):
    """Forward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. → (out [B, M, C], s1 [2, C], s2 [2, Cs])."""
    global fwd_launches
    if q.device.type == "cpu":
        return pt_attn_plain(q, kv, rel, li, starts, tile, width, params)
    (q, kv, rel, li, st), ps, (b, m, k, c, cs) = _cuda_args(
        q, kv, rel, li, starts, tile, width, params)
    plan = fwd_plan(b, m, k, c)
    out = torch.empty((b, m, c), dtype=q.dtype, device=q.device)
    stats = torch.empty((plan.blocks, 2 * c + 2 * cs), dtype=torch.float32, device=q.device)
    ptrs = _pointers(ps)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().cbl_pt_attn_fwd(
        q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(), stats.data_ptr(),
        b, m, k, c, tile, width, plan.blocks, plan.threads, plan.rows, plan.chunk, plan.smem,
        q.element_size(), stream,
    )
    fwd_launches += 1
    fwd_dtype_launches[DTYPES[q.dtype]] += 1
    build.check(rc, "cbl_pt_attn_fwd")
    sums = stats.sum(0) / (b * m * k)
    return out, sums[: 2 * c].view(2, c), sums[2 * c:].view(2, cs)


def pt_attn_bwd(q, kv, rel, li, starts, tile: int, width: int, params, g_out):
    """Backward: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. → (dq, dkv, 12 parameter gradients shaped as ``params``). The
    kernel reads g_out in q's dtype (a float32 g_out for bfloat16 q is
    refused: rounding it would lose what the reference keeps)."""
    global bwd_launches
    if q.device.type == "cpu":
        return pt_attn_bwd_plain(q, kv, rel, li, starts, tile, width, params, g_out)
    (q, kv, rel, li, st), ps, (b, m, k, c, cs) = _cuda_args(
        q, kv, rel, li, starts, tile, width, params)
    if g_out.shape != q.shape or g_out.device != q.device:
        raise ValueError(f"g_out {tuple(g_out.shape)} on {g_out.device} vs q {tuple(q.shape)}")
    if g_out.dtype not in DTYPES or g_out.element_size() > q.element_size():
        raise TypeError(f"pt_attn_bwd takes g_out of q's dtype {q.dtype}, got {g_out.dtype}")
    g_out = g_out.to(q.dtype).contiguous()
    sizes = _prow(c, cs)
    plan = bwd_plan(b, m, k, c)
    dq = torch.empty((b, m, c), dtype=torch.float32, device=q.device)
    dkv = torch.zeros((b, m, 2 * c), dtype=torch.float32, device=q.device)
    dp = torch.empty((plan.blocks, sum(sizes)), dtype=torch.float32, device=q.device)
    ptrs = _pointers(ps)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().cbl_pt_attn_bwd(
        q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), g_out.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
        dp.data_ptr(), b, m, k, c, tile, width, plan.blocks, plan.threads, plan.rows,
        plan.chunk, plan.smem, q.element_size(), stream,
    )
    bwd_launches += 1
    bwd_dtype_launches[DTYPES[q.dtype]] += 1
    build.check(rc, "cbl_pt_attn_bwd")
    flat = dp.sum(0)
    grads = tuple(g.view(p.shape) for g, p in zip(torch.split(flat, sizes), params))
    return dq.to(q.dtype), dkv.to(kv.dtype), grads

"""The host-side launch plans of the port's forward gather, CBL stats
forward and backward and fused-attention forward and backward kernels
(ops/cuda/tile_gather.py::gather_plan, ops/cuda/cbl_dense.py::fwd_plan,
::bwd_plan and ::scatter_slot_ranges, ops/cuda/pt_attn.py::fwd_plan and
::bwd_plan), at every call shape of the flagship B=2 x N=65536 train step
(the request's gathers have the same shapes; the stale step's 18 attention
layers), at the shapes the reference trains beyond the flagship's (the
attention at C = 512 with K in {8, 32, 48}, CBL windows wider than shared
memory holds), and the scalar-read gather path's (row, channel) counter,
which csrc/tile_gather.cu steps without a division; the CBL kernels' plans
at every width the CBL head's options give them (13 to 512 channels, the
rows padded to the kernels' 32, 64, 128, 256 or 512). No card is needed."""
import re
from pathlib import Path

import numpy as np
import pytest

from contrastboundary_tpu_torch.ops.cuda import cbl_dense
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda import pt_attn
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg

# (x, idx) of the window_gather calls of the flagship train step
GATHER_CALLS = [
    ((2, 65536, 3), (2, 65536, 8)), ((2, 16384, 3), (2, 16384, 16)),
    ((2, 4096, 3), (2, 4096, 16)), ((2, 1024, 3), (2, 1024, 16)),
    ((2, 256, 3), (2, 256, 16)), ((2, 65536, 3), (2, 16384, 16)),
    ((2, 16384, 3), (2, 4096, 16)), ((2, 4096, 3), (2, 1024, 16)),
    ((2, 1024, 3), (2, 256, 16)), ((2, 65536, 64), (2, 65536, 8)),
    ((2, 65536, 35), (2, 16384, 16)), ((2, 16384, 128), (2, 16384, 16)),
    ((2, 16384, 67), (2, 4096, 16)), ((2, 4096, 256), (2, 4096, 16)),
    ((2, 4096, 131), (2, 1024, 16)), ((2, 1024, 512), (2, 1024, 16)),
    ((2, 1024, 259), (2, 256, 16)), ((2, 256, 1024), (2, 256, 16)),
    ((2, 256, 256), (2, 1024, 3)), ((2, 1024, 128), (2, 4096, 3)),
    ((2, 4096, 64), (2, 16384, 3)), ((2, 16384, 32), (2, 65536, 3)),
    ((2, 16384, 32), (2, 65536, 1)), ((2, 4096, 32), (2, 65536, 1)),
    ((2, 1024, 32), (2, 65536, 1)), ((2, 256, 32), (2, 65536, 1)),
]
# the widths chip_smoke.py gathers directly
GRID_WIDTHS = (1, 2, 3, 5, 35, 67, 131, 259, 1024)
# (lanes a row, pieces a lane) that csrc/tile_gather.cu instantiates
VECTOR_KERNELS = {(4, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4)}
# (M, K, tile, width, window) of the five dense-CBL stages of the flagship
CBL_CALLS = [(65536, 35, 256, 3, 1), (16384, 23, 256, 3, 1), (4096, 23, 256, 3, 1),
             (1024, 23, 256, 3, 1), (256, 23, 256, 1, 0)]
# (C, M, K) of the stale step's 18 attention layers, in layer order: encoder
# blocks (2, 3, 4, 6, 3) less one transition a level, then the 5 decoder blocks
ATTN_CALLS = ([(32, 65536, 8)] + [(64, 16384, 16)] * 2 + [(128, 4096, 16)] * 3
              + [(256, 1024, 16)] * 5 + [(512, 256, 16)] * 2
              + [(512, 256, 16), (256, 1024, 16), (128, 4096, 16), (64, 16384, 16),
                 (32, 65536, 8)])
SMEM_PER_SM = 233472  # an H100 SM's shared memory; each resident block takes 1 KB more


def _check_gather_plan(rows, c, aligned, elem_bytes=4):
    plan = tg.gather_plan(rows, c, aligned, elem_bytes)
    blocks, chunks = plan.grid
    assert plan.rw & (plan.rw - 1) == 0 and plan.rw <= 32
    assert blocks * tg.WARPS_PER_BLOCK * plan.rw >= rows
    assert (blocks - 1) * tg.WARPS_PER_BLOCK * plan.rw < rows
    if (c * elem_bytes) % 16 == 0 and aligned:
        cv = c * elem_bytes // 16
        assert (plan.lpg, plan.nt) in VECTOR_KERNELS
        chunk = plan.lpg * plan.nt
        assert chunks * chunk >= cv > (chunks - 1) * chunk
        assert plan.lpg >= min(cv, 32) and (plan.lpg == 4 or plan.lpg // 2 < cv)
        loads_ahead = plan.nt * (1 if plan.nt >= 4 else 4 // plan.nt)
        assert loads_ahead >= 4  # 16-byte loads a lane before its first store
        min_rw, row_bytes, target = 32 // plan.lpg, 16 * min(cv, chunk), tg.VEC_WARP_BYTES
    else:
        assert plan.lpg == 0 and chunks == 1
        assert plan.rw % 4 == 0  # the warp's run starts aligned to 4 elements
        min_rw, row_bytes, target = 4, elem_bytes * c, tg.SCALAR_WARP_BYTES
    assert plan.rw >= min_rw
    assert plan.rw == min_rw or plan.rw * row_bytes <= target
    assert plan.rw == 32 or 2 * plan.rw * row_bytes > target
    return plan


@pytest.mark.parametrize("x,idx", GATHER_CALLS)
def test_gather_plan_at_flagship_calls(x, idx):
    b, m, k = idx
    c = x[2]
    plan = _check_gather_plan(b * m * k, c, True)
    assert (plan.lpg == 0) == (c % 4 != 0)  # odd widths take the scalar-read path
    # a misaligned x or out always takes the scalar-read path
    assert _check_gather_plan(b * m * k, c, False).lpg == 0


# (kv, idx) of the bfloat16 window_gather calls of the flagship bf16 step:
# the 18 attention layers' [k | v] rows, 2C = 64 ... 1024 of them
BF16_GATHER_CALLS = [((2, 65536, 64), (2, 65536, 8)), ((2, 16384, 128), (2, 16384, 16)),
                     ((2, 4096, 256), (2, 4096, 16)), ((2, 1024, 512), (2, 1024, 16)),
                     ((2, 256, 1024), (2, 256, 16))]


@pytest.mark.parametrize("x,idx", BF16_GATHER_CALLS)
def test_gather_plan_for_bf16_rows(x, idx):
    """A bfloat16 row of C elements moves as the bits of a float32 row of
    C / 2: the same vector-path plan at every flagship bf16 call; widths that
    are not whole 16-byte pieces (C % 8 != 0) take the scalar-read path, and
    so does a misaligned x or out."""
    b, m, k = idx
    c = x[2]
    plan = _check_gather_plan(b * m * k, c, True, elem_bytes=2)
    assert plan.lpg > 0 and plan == tg.gather_plan(b * m * k, c // 2, True)
    assert _check_gather_plan(b * m * k, c, False, elem_bytes=2).lpg == 0
    for odd in (c + 2, c + 4, c - 1):
        assert _check_gather_plan(b * m * k, odd, True, elem_bytes=2).lpg == 0


@pytest.mark.parametrize("c", GRID_WIDTHS)
def test_gather_plan_at_the_direct_widths(c):
    for rows in (2 * 4096 * 16, 2 * 16384 * 3, 7, 1):
        for aligned in (True, False):
            _check_gather_plan(rows, c, aligned)


@pytest.mark.parametrize("c", GRID_WIDTHS + (12, 20))
def test_scalar_path_counter_walks_each_float_of_the_run(c):
    """csrc/tile_gather.cu's scalar-read path: lane l starts at float 4l of
    its warp's run with (row, channel) = divmod(4l, C) and adds (128 // C,
    128 % C) with one carry for each step of 32 pieces; inside a piece the
    channel counter wraps at C. Every float of the run is visited once, at
    its own (row, channel)."""
    for rw in (4, 8, 16, 32):
        n = rw * c
        seen = []
        for lane in range(32):
            t, cc = divmod(4 * lane, c)
            dt, dc = divmod(128, c)
            for v0 in range(0, (n + 3) // 4, 32):
                tt, ci = t, cc
                for u in range(4):
                    e = 4 * (v0 + lane) + u
                    assert (tt, ci) == divmod(e, c)
                    if e < n:
                        seen.append(e)
                    ci += 1
                    if ci == c:
                        ci, tt = 0, tt + 1
                t, cc = t + dt, cc + dc
                if cc >= c:
                    cc, t = cc - c, t + 1
        assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("m,k,tile,width,window", CBL_CALLS)
def test_cbl_bwd_plan_at_flagship_stages(m, k, tile, width, window):
    b = 2
    p1_blocks, rows, (blocks, clouds) = cbl_dense.bwd_plan(b, m, tile)
    assert p1_blocks * 256 == b * m * 8  # 8 lanes a query row, every row once
    assert rows & (rows - 1) == 0 and tile % rows == 0
    assert cbl_dense.MIN_SCATTER_ROWS <= rows <= cbl_dense.MAX_SCATTER_ROWS
    assert clouds == b and blocks * rows == m  # every support row in one block
    assert blocks * b >= cbl_dense.MIN_SCATTER_BLOCKS or rows == cbl_dense.MIN_SCATTER_ROWS
    assert rows == min(tile, cbl_dense.MAX_SCATTER_ROWS) or blocks * b < 2 * cbl_dense.MIN_SCATTER_BLOCKS
    assert m * k < 2**23 and k <= cbl_dense.MAX_K  # the kernel's limits
    smem = (2 * rows * 32 + 2 * 4096) * 4
    assert smem <= 227 * 1024


@pytest.mark.parametrize("m,k,tile,width,window", CBL_CALLS + [(64, 5, 16, 3, 1), (48, 4, 16, 3, 1)])
def test_scatter_slot_ranges_hold_every_landing_slot(m, k, tile, width, window):
    """The scatter's slot range of support tile s (two binary searches over
    the self geometry's window starts) is exactly the slots of the query
    tiles whose windows hold s: every slot whose window-relative index can
    land in tile s lies inside it, and every query tile inside it can land
    there."""
    g = m // tile
    ranges = cbl_dense.scatter_slot_ranges(m, k, tile, width, window)
    starts = cbl_dense.self_window_starts(m, tile, width, window)
    assert ranges.shape == (g, 2) and np.all(ranges % (k * tile) == 0)
    for s in range(g):
        holders = [t for t in range(g) if starts[t] <= s < starts[t] + width]
        assert list(range(ranges[s, 0] // (k * tile), ranges[s, 1] // (k * tile))) == holders
    assert np.all(np.diff(ranges[:, 0]) >= 0) and np.all(np.diff(ranges[:, 1]) >= 0)


@pytest.mark.parametrize("k", [1, 2, 3, 23, 35, 36, 255, 256])
def test_scatter_quotient_without_division(k):
    """csrc/cbl_dense.cu's scatter takes a slot's query row as slot / K by a
    float product, (int)(slot * (1 / K)) in float32, moved by one where it
    misses: exact for every slot below the kernel's limit of 2^23."""
    n = np.arange(0, 1 << 23, dtype=np.int64)
    inv = np.float32(1) / np.float32(k)
    q = (n.astype(np.float32) * inv).astype(np.int64)
    q = q + (n >= (q + 1) * k) - (n < q * k)
    np.testing.assert_array_equal(q, n // k)


def _fwd_coverage(b, m, k, tile, blocks, threads):
    """(row, slot) pairs the forward's blocks, lanes and chunks serve: block
    (x, b) takes rows [x·rows, (x + 1)·rows) of cloud b, 8 lanes a row, 64
    rows at a time; chunk c, lane l holds slots c·8·spl + l·spl + j."""
    rows = m // blocks
    spl, nch = cbl_dense.fwd_lane_slots(k)
    groups = threads // cbl_dense.FWD_LANES
    seen = np.zeros((b, m, k), np.int64)
    for x in range(blocks):
        for rr0 in range(0, rows, groups):
            rr = np.arange(rr0, min(rr0 + groups, rows))
            for c in range(nch):
                for lane in range(cbl_dense.FWD_LANES):
                    for j in range(spl):
                        kk = c * cbl_dense.FWD_LANES * spl + lane * spl + j
                        if kk < k:
                            seen[:, x * rows + rr, kk] += 1
    return seen


@pytest.mark.parametrize("m,k,tile,width,window", CBL_CALLS + [(128, 70, 32, 3, 1), (64, 6, 16, 3, 1)])
def test_cbl_fwd_plan_at_flagship_stages(m, k, tile, width, window):
    """The forward's geometry: a block's rows lie in one tile, every (row,
    slot) is served exactly once and in slot order along (chunk, lane,
    slot), at most 512 threads, the window fits in shared memory (two
    blocks to an SM at the flagship's W = 768)."""
    b = 2
    blocks, threads, smem = cbl_dense.fwd_plan(b, m, k, tile, width)
    rows = m // blocks
    assert blocks * rows == m and tile % rows == 0 and rows & (rows - 1) == 0
    assert cbl_dense.FWD_MIN_ROWS <= rows or rows == tile & -tile
    assert blocks * b >= cbl_dense.SM_COUNT // 2 or rows == cbl_dense.FWD_MIN_ROWS or rows == tile & -tile
    assert rows == min(tile & -tile, 256) or (m // (2 * rows)) * b < cbl_dense.SM_COUNT // 2
    assert threads % 32 == 0 and threads <= 1024 and threads <= cbl_dense.FWD_MAX_THREADS
    assert smem == cbl_dense.fwd_smem(width, tile) <= cbl_dense.SMEM_LIMIT
    if width * tile == 768:
        assert 2 * (smem + 1024) <= SMEM_PER_SM
    assert np.all(_fwd_coverage(b, m, k, tile, blocks, threads) == 1)
    spl, nch = cbl_dense.fwd_lane_slots(k)
    order = [c * 8 * spl + lane * spl + j for c in range(nch) for lane in range(8)
             for j in range(spl) if c * 8 * spl + lane * spl + j < k]
    assert order == list(range(k))  # the lanes' turns add the slots in order
    assert spl == min(-(-k // 8), 8) and (nch == 1 or spl == 8)


def test_cbl_fwd_plan_serves_a_window_beyond_shared_memory():
    """Windows over 1,660 rows (a wider self window, a larger tile) are read
    through L2 (0 dynamic shared bytes) with the staged path's geometry:
    every (row, slot) served once, in slot order."""
    b, m, k = 2, 65536, 36
    for tile, width in ((256, 7), (1024, 3)):
        assert cbl_dense.fwd_smem(width, tile) > cbl_dense.SMEM_LIMIT
        blocks, threads, smem = cbl_dense.fwd_plan(b, m, k, tile, width)
        rows = m // blocks
        assert smem == 0
        assert blocks * rows == m and tile % rows == 0 and rows & (rows - 1) == 0
        assert threads % 32 == 0 and threads <= cbl_dense.FWD_MAX_THREADS
        assert np.all(_fwd_coverage(b, m, k, tile, blocks, threads) == 1)


# (C, M, K, tile, width) of the CBL kernels at the widths the CBL head's
# options give them on the flagship pyramid: the class counts (13, 20) at
# levels 0 and 4, each level's planes (f_out), and a width between two of
# the kernels' (300)
WIDE_CBL_CALLS = [(13, 65536, 35, 256, 3), (20, 256, 23, 256, 1), (64, 16384, 23, 256, 3),
                  (128, 4096, 23, 256, 3), (256, 1024, 23, 256, 3), (512, 256, 23, 256, 1),
                  (300, 1024, 23, 256, 3)]
SCATTER_STATIC_SMEM = 11344  # the ACTIVE scatter's static shared bytes (ptxas)


def _source(name):
    return (Path(cbl_dense.__file__).resolve().parents[2] / "csrc" / name).read_text()


def test_cbl_kernel_widths_match_the_sources():
    """The row widths the wrappers pad to are the C entries' instances:
    csrc/cbl_dense.cu's forward and backward dispatch, the scatter's
    static_assert, csrc/cbl_tile2.cu's by_width."""
    dense = _source("cbl_dense.cu")
    for macro in ("CBL_FWD_WIDTH", "CBL_BWD_WIDTH"):
        got = tuple(int(c) for c in re.findall(rf"^\s*{macro}\((\d+)\)", dense, re.M))
        assert got == cbl_dense.WIDTHS, macro
    scatter = re.search(r"static_assert\(((?:C == \d+(?: \|\|\s*)?)+)",
                        _source("slot_scatter.cuh")).group(1)
    assert tuple(int(c) for c in re.findall(r"\d+", scatter)) == cbl_dense.WIDTHS
    by_width = _source("cbl_tile2.cu").split("int by_width(")[1].split("default:")[0]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", by_width)) == cbl_dense.WIDTHS


@pytest.mark.parametrize("c,m,k,tile,width", WIDE_CBL_CALLS)
def test_cbl_plans_at_every_width(c, m, k, tile, width):
    """The dense kernels' plans at a width: the row width padded up to the
    next kernel width; the window staged in shared memory where it fits
    (else through L2: 0 bytes), every (row, slot) served once; the
    backward's scatter rows a power-of-two divisor of the tile within the
    width's accumulator, its shared memory within the SM's. The v2
    kernels' plans: the same padding, four slots a lane beyond 32 channels,
    the scatter's rows within the width's accumulator."""
    b = 2
    kc = cbl_dense.padded_channels(c)
    assert kc in cbl_dense.WIDTHS and c <= kc < 2 * max(c, 32)
    blocks, threads, smem = cbl_dense.fwd_plan(b, m, k, tile, width, c)
    need = cbl_dense.fwd_smem(width, tile, c)
    assert need == width * tile * (4 * kc + 12)
    assert smem == (need if need <= cbl_dense.SMEM_LIMIT else 0)
    assert threads % 32 == 0 and threads <= cbl_dense.FWD_MAX_THREADS
    assert np.all(_fwd_coverage(b, m, k, tile, blocks, threads) == 1)
    p1_blocks, rows, (sblocks, clouds) = cbl_dense.bwd_plan(b, m, tile, c)
    assert p1_blocks * 256 == b * m * 8 and clouds == b and sblocks * rows == m
    assert rows & (rows - 1) == 0 and tile % rows == 0
    assert cbl_dense.MIN_SCATTER_ROWS <= rows <= cbl_dense.scatter_max_rows(kc)
    assert rows * kc <= cbl_dense.SCATTER_FLOATS
    assert (2 * rows * kc + 2 * 4096) * 4 + SCATTER_STATIC_SMEM <= 227 * 1024
    v2 = c2.bwd_plan(b, m, k, c, tile)
    assert v2.pass1.channels == kc and v2.pass1.slots == (4 if kc > 32 else v2.pass1.slots)
    assert v2.scatter_rows * kc <= c2.SCATTER_FLOATS and tile % v2.scatter_rows == 0
    assert v2.scatter_smem + SCATTER_STATIC_SMEM <= 227 * 1024


def test_cbl_widths_beyond_the_kernels_are_refused():
    for c in (0, 513):
        with pytest.raises(ValueError, match="1 to 512"):
            cbl_dense.padded_channels(c)


def _check_attn_plan(plan, b, m, k, c, kind, min_rows):
    """An attention kernel's geometry: tiles of ``rows`` query rows x all K
    slots, taken by the persistent grid's blocks in turn, and ``chunk``
    slots of each row at a time, cover every (row, slot) exactly once; at
    most 1024 threads, at least C; shared memory within the limit and
    holding the kernel's layout; the slots in chunks only where a row's
    slot-rows do not fit, in the fewest chunks of equal size that do; the
    grid fits the card at once."""
    smem_of = pt_attn.fwd_smem if kind == "fwd" else pt_attn.bwd_smem
    assert c <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.rows & (plan.rows - 1) == 0 and plan.rows % min_rows == 0
    assert plan.rows * k * c <= pt_attn.TILE_FLOATS or plan.rows == min_rows
    assert 1 <= plan.chunk <= k
    assert plan.smem == smem_of(c, plan.rows, k, plan.chunk) <= pt_attn.SMEM_LIMIT
    n_chunks = -(-k // plan.chunk)
    if plan.chunk < k:
        assert plan.rows == min_rows and smem_of(c, plan.rows, k, k) > pt_attn.SMEM_LIMIT
        assert smem_of(c, plan.rows, k, -(-k // (n_chunks - 1))) > pt_attn.SMEM_LIMIT
        assert plan.chunk == -(-k // n_chunks)  # chunks of equal size, the last no longer
    per_sm = pt_attn.blocks_per_sm(c, kind)
    if plan.rows > min_rows:  # the blocks an SM is built for fit
        assert per_sm * (plan.smem + 1024) <= SMEM_PER_SM
    per_sm = min(per_sm, SMEM_PER_SM // (plan.smem + 1024))
    tiles = -(-b * m // plan.rows)
    assert plan.blocks == min(tiles, pt_attn.SM_COUNT * per_sm) >= 1
    seen = np.zeros(b * m * k, np.int64)
    for blk in range(plan.blocks):
        for tl in range(blk, tiles, plan.blocks):
            rows = np.arange(tl * plan.rows, min((tl + 1) * plan.rows, b * m))
            for k0 in range(0, k, plan.chunk):
                slots = np.arange(k0, min(k0 + plan.chunk, k))
                seen[(rows[:, None] * k + slots[None, :]).reshape(-1)] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("c,m,k", ATTN_CALLS)
def test_pt_attn_bwd_plan_at_stale_layers(c, m, k):
    """The attention backward's geometry (``_check_attn_plan``) at the
    stale step's layers: no chunks, and each channel's thread group of the
    last phase gets whole rows."""
    b = 2
    plan = pt_attn.bwd_plan(b, m, k, c)
    _check_attn_plan(plan, b, m, k, c, "bwd", plan.threads // c)
    assert plan.chunk == k
    if plan.threads == 256:  # two blocks to an SM
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    groups = plan.threads // c
    assert (plan.rows * k // groups) % k == 0  # a group's slot-rows are whole query rows


@pytest.mark.parametrize("c,m,k", ATTN_CALLS)
def test_pt_attn_fwd_plan_at_stale_layers(c, m, k):
    """The attention forward's geometry (``_check_attn_plan``) at the stale
    step's layers: no chunks; level 4 (C = 512, 512 rows) in tiles of one
    row, so that every SM gets tiles."""
    b = 2
    plan = pt_attn.fwd_plan(b, m, k, c)
    _check_attn_plan(plan, b, m, k, c, "fwd", 1)
    assert plan.chunk == k
    assert -(-b * m // plan.rows) >= pt_attn.SM_COUNT


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("m,k", [(65536, 8), (1024, 8), (256, 32), (256, 48)])
def test_pt_attn_plans_at_c512_beyond_the_flagship(kind, m, k):
    """C = 512 with K = 8 (the reference's nsample with k_self[4] = 8) and
    K = 32 and 48: a plan within the shared memory a block can have; at
    K > 16 the slots go in chunks."""
    b, c = 2, 512
    plan = (pt_attn.fwd_plan if kind == "fwd" else pt_attn.bwd_plan)(b, m, k, c)
    _check_attn_plan(plan, b, m, k, c, kind, plan.threads // c if kind == "bwd" else 1)
    assert plan.smem <= pt_attn.SMEM_LIMIT
    assert (plan.chunk < k) == (k > 16)


def _tiling_constant(name: str, cs: int):
    """The value at CS = cs of a ``Tiling<CS>`` constant of csrc/pt_attn.cu
    written ``CS >= n ? a : b`` or ``CS <= n``."""
    text = (Path(pt_attn.__file__).parents[2] / "csrc" / "pt_attn.cu").read_text()
    hit = re.search(rf"static constexpr (?:int|bool) {name} =\s*CS (>=|<=) (\d+)"
                    rf"(?: \? (\d+) : (\d+))?;", text)
    assert hit, name
    op, n, a, b = hit.groups()
    holds = cs >= int(n) if op == ">=" else cs <= int(n)
    return holds if a is None else int(a if holds else b)


@pytest.mark.parametrize("c", pt_attn.CHANNELS)
def test_pt_attn_plan_constants_match_the_kernel(c):
    """The plans' copies of the kernels' thread count, blocks an SM (their
    launch bounds) and w_pre stash are csrc/pt_attn.cu's ``Tiling``
    constants at every width."""
    cs = c // pt_attn.SHARES
    assert pt_attn.tile_threads(c) == _tiling_constant("T", cs)
    assert pt_attn.blocks_per_sm(c, "fwd") == _tiling_constant("FWD_BLOCKS", cs)
    assert pt_attn.blocks_per_sm(c, "bwd") == _tiling_constant("BWD_BLOCKS", cs)
    assert pt_attn.bwd_stash(c) == _tiling_constant("STASH", cs)

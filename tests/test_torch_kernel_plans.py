"""The host-side launch plans of the port's forward gather and CBL stats
backward kernels (ops/cuda/tile_gather.py::gather_plan,
ops/cuda/cbl_dense.py::bwd_plan and ::scatter_slot_ranges), at every call
shape of the flagship B=2 x N=65536 train step (the request's gathers have
the same shapes), and the scalar-read gather path's (row, channel) counter,
which csrc/tile_gather.cu steps without a division. No card is needed."""
import numpy as np
import pytest

from contrastboundary_tpu_torch.ops.cuda import cbl_dense
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


def _check_gather_plan(rows, c, aligned):
    plan = tg.gather_plan(rows, c, aligned)
    blocks, chunks = plan.grid
    assert plan.rw & (plan.rw - 1) == 0 and plan.rw <= 32
    assert blocks * tg.WARPS_PER_BLOCK * plan.rw >= rows
    assert (blocks - 1) * tg.WARPS_PER_BLOCK * plan.rw < rows
    if c % 4 == 0 and aligned:
        cv = c // 4
        assert (plan.lpg, plan.nt) in VECTOR_KERNELS
        chunk = plan.lpg * plan.nt
        assert chunks * chunk >= cv > (chunks - 1) * chunk
        assert plan.lpg >= min(cv, 32) and (plan.lpg == 4 or plan.lpg // 2 < cv)
        loads_ahead = plan.nt * (1 if plan.nt >= 4 else 4 // plan.nt)
        assert loads_ahead >= 4  # 16-byte loads a lane before its first store
        min_rw, row_bytes, target = 32 // plan.lpg, 16 * min(cv, chunk), tg.VEC_WARP_BYTES
    else:
        assert plan.lpg == 0 and chunks == 1
        assert plan.rw % 4 == 0  # the warp's run starts 16-byte aligned
        min_rw, row_bytes, target = 4, 4 * c, tg.SCALAR_WARP_BYTES
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

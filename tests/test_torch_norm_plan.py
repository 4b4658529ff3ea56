"""The fused norms' launch plan as a pure function of the call, held on
the CPU (no kernel runs): ``tony_tpu_torch.ops.fused.plan``, the
constants of ``csrc/fused_norms.cu`` mirrored in Python.

The rules: rows up to MAX_ROW_WARPS * 32 * LANE_VALUES wide take the
one-pass route, the fewest warps a row that keep a lane within
LANE_VALUES fp32 values, and the fewest 16-byte vectors a lane that
cover the row with them; a row's scalar head and tail take what the
vectors leave. The blocks, looping over rows with stride grid *
block_rows, take every row once; a block loops (the grid one wave of
BLOCKS_PER_SM blocks an SM) only where the scale it stages is at least
what its rows load at a time, and at D = 1536 every SM keeps
IN_FLIGHT_BYTES of loads in flight. Wider rows take the two-pass route,
a warp a row.
"""

import pytest
import torch

from tony_tpu_torch.ops import fused

H100_SMS = 132
BF16, FP32 = torch.bfloat16, torch.float32
# the Llama-family widths the port loads (Qwen2.5-0.5B's 896 to
# Llama-3-70B's 8192), the smoke's, and ragged ones
WIDTHS = [896, 1024, 1536, 2048, 3072, 3584, 4096, 5120, 8192, 1000, 100,
          7, 1]
ROWS = [1, 7, 8, 9, 63, 1000, 4096, 8192, 100000]
DTYPES = [(FP32, None), (BF16, None), (FP32, FP32), (BF16, BF16),
          (FP32, BF16), (BF16, FP32)]


def _lane_bytes(p, x_dt, r_dt):
    """Bytes of x and r a lane holds in flight on the one-pass route."""
    ve = fused.vector_elems(x_dt)
    return p.lane_vectors * (16 + ve * (0 if r_dt is None else r_dt.itemsize))


def _rows_taken(p, rows):
    """Every row each (block, row group) takes: rows g + b * block_rows,
    then on with stride grid * block_rows (the kernel's loop)."""
    stride = p.grid * p.block_rows
    return [row for b in range(p.grid) for g in range(p.block_rows)
            for row in range(b * p.block_rows + g, rows, stride)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", [1536, 4096, 8192, 12289, 7])
@pytest.mark.parametrize("x_dt,r_dt", DTYPES[:4])
def test_blocks_take_every_row_once(rows, d, x_dt, r_dt):
    p = fused.plan(rows, d, x_dt, r_dt, H100_SMS)
    taken = _rows_taken(p, rows)
    assert sorted(taken) == list(range(rows))
    if p.route == fused.ONE_PASS:
        assert p.block_rows * p.row_warps <= fused.BLOCK_WARPS
        staged, loaded = 4, p.block_rows * (
            x_dt.itemsize + (0 if r_dt is None else r_dt.itemsize))
        if staged >= loaded:  # one wave, looping over the rows
            assert p.grid == min(-(-rows // p.block_rows),
                                 fused.BLOCKS_PER_SM * H100_SMS)
        else:  # a block a row group
            assert p.grid == -(-rows // p.block_rows)
    else:  # a block for every BLOCK_WARPS rows: no block loops
        assert len(taken) == rows and p.grid * p.block_rows < rows + 8


def _layout(d, h, ve):
    """The kernel's row layout with h head elements (x's pointer h
    elements before a 16-byte boundary): whole vectors after the head,
    then a tail of fewer than a vector (``layout`` in the kernel)."""
    if h > d:
        return None
    nvb = (d - h) // ve
    return nvb, d - h - nvb * ve


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("x_dt,r_dt", DTYPES)
def test_lanes_cover_the_row_with_a_scalar_head_and_tail(d, x_dt, r_dt):
    """Warps a row x 32 lanes x vectors a lane cover D, at every head
    the kernel can meet; head and tail, each under one vector, take the
    rest, and each element of the row is taken exactly once."""
    p = fused.plan(64, d, x_dt, r_dt, H100_SMS)
    assert p.route == fused.ONE_PASS
    ve = fused.vector_elems(x_dt)
    nt = p.row_warps * 32
    assert nt * p.lane_vectors * ve >= d
    for h in range(ve):
        layout = _layout(d, h, ve)
        if layout is None:  # shorter than its head: element by element
            assert d < ve
            continue
        nvb, t = layout
        assert 0 <= t < ve
        assert nvb <= nt * p.lane_vectors  # every vector has a lane
        taken = [0] * d
        for c in range(h):
            taken[c] += 1
        for tid in range(nt):
            for k in range(p.lane_vectors):
                v = tid + k * nt
                if v < nvb:
                    for j in range(ve):
                        taken[h + v * ve + j] += 1
        for c in range(h + nvb * ve, d):
            taken[c] += 1
        assert taken == [1] * d


@pytest.mark.parametrize("x_dt,r_dt", DTYPES)
def test_no_plan_exceeds_the_register_budget(x_dt, r_dt):
    """At every one-pass width a lane holds at most LANE_VALUES fp32
    values and 8 bytes of loads a value (fp32 x and r), with the fewest
    warps and vectors that do."""
    ve = fused.vector_elems(x_dt)
    for d in range(1, fused.MAX_ROW_WARPS * 32 * fused.LANE_VALUES + 1):
        p = fused.plan(8192, d, x_dt, r_dt, H100_SMS)
        assert p.route == fused.ONE_PASS
        assert 1 <= p.row_warps <= fused.MAX_ROW_WARPS
        assert p.lane_vectors * ve <= fused.LANE_VALUES
        assert _lane_bytes(p, x_dt, r_dt) <= 8 * fused.LANE_VALUES
        assert p.row_warps == 1 \
            or (p.row_warps - 1) * 32 * fused.LANE_VALUES < d
        assert (p.lane_vectors - 1) * ve * 32 * p.row_warps < d


@pytest.mark.parametrize("x_dt", [FP32, BF16])
def test_every_model_width_takes_one_pass(x_dt):
    """Every width from 896 to 8192 (the Llama-family models the port
    loads) gets a one-pass plan."""
    for d in range(896, 8193):
        p = fused.plan(8192, d, x_dt, x_dt, H100_SMS)
        assert p.route == fused.ONE_PASS and p.lane_vectors > 0, d


@pytest.mark.parametrize("d,route", [
    (fused.MAX_ROW_WARPS * 32 * fused.LANE_VALUES, fused.ONE_PASS),
    (fused.MAX_ROW_WARPS * 32 * fused.LANE_VALUES + 1, fused.TWO_PASS),
    (65536, fused.TWO_PASS)])
def test_route_by_width(d, route):
    p = fused.plan(100, d, BF16, None, H100_SMS)
    assert p.route == route
    if route == fused.TWO_PASS:
        assert (p.row_warps, p.lane_vectors, p.block_rows) == \
            (1, 0, fused.BLOCK_WARPS)
        assert p.grid == -(-100 // fused.BLOCK_WARPS)


@pytest.mark.parametrize("x_dt,r_dt", DTYPES)
def test_enough_bytes_in_flight_at_the_smoke_call(x_dt, r_dt):
    """At D = 1536 and 8192 rows an SM holds BLOCKS_PER_SM blocks at
    least (the kernel's launch bounds), and their lanes' loads make at
    least IN_FLIGHT_BYTES."""
    p = fused.plan(8192, 1536, x_dt, r_dt, H100_SMS)
    per_sm = min(p.grid / H100_SMS, fused.BLOCKS_PER_SM)
    lanes = p.block_rows * p.row_warps * 32
    assert per_sm * lanes * _lane_bytes(p, x_dt, r_dt) \
        >= fused.IN_FLIGHT_BYTES


@pytest.mark.parametrize("d", [896, 1536, 4096, 8192, 12289])
@pytest.mark.parametrize("x_dt,r_dt", DTYPES[:4])
def test_eight_rows_are_one_wave_of_one_launch(d, x_dt, r_dt):
    """At 8 rows every row has its own row group at once: no block
    loops, and the blocks fit on the card."""
    p = fused.plan(8, d, x_dt, r_dt, H100_SMS)
    assert p.grid * p.block_rows >= 8 and p.grid <= H100_SMS
    assert sorted(_rows_taken(p, 8)) == list(range(8))


def test_plans_at_the_smoke_calls():
    """Pinned on an H100 (132 SMs): D = 1536 two warps a row, 4096 four,
    8192 eight; a block a row group at D = 1536, and one looping wave of
    two blocks an SM where a block stages as much scale as it loads."""
    def plan(rows, d, x_dt, r_dt=None):
        return tuple(fused.plan(rows, d, x_dt, r_dt, H100_SMS))
    assert plan(8192, 1536, FP32) == (fused.ONE_PASS, 2, 6, 4, 2048)
    assert plan(8192, 1536, BF16, BF16) == (fused.ONE_PASS, 2, 3, 4, 2048)
    assert plan(8, 1536, FP32, FP32) == (fused.ONE_PASS, 2, 6, 4, 2)
    assert plan(4096, 4096, BF16) == (fused.ONE_PASS, 4, 4, 2, 264)
    assert plan(4096, 4096, FP32) == (fused.ONE_PASS, 4, 8, 2, 2048)
    assert plan(4096, 8192, BF16, BF16) == (fused.ONE_PASS, 8, 4, 1, 264)
    assert plan(4096, 8192, FP32, FP32) == (fused.ONE_PASS, 8, 8, 1, 4096)

"""Launch plans of two kernels as pure functions of the call, held on the
CPU (no kernel runs): q8_matmul's route, grid and K splits
(``tony_tpu_torch.ops.quant.plan``, the tile constants of
``csrc/q8_matmul.cu`` mirrored in Python), and fused AdamW's chunk table
and its vector/scalar split of a leaf (``tony_tpu_torch.ops.adamw``).

q8_matmul's rules: m <= DEC_ROWS takes the decode route, above it a bf16
x the tensor cores and an fp32 x the SIMT tile; the blocks cover every
(row, column) output once; the K splits cover k exactly, each a whole
number of stages, and the decode route's splits of a slab make one
cluster; at the decode shapes the grid is one wave, and every SM keeps
at least IN_FLIGHT_BYTES of weight loads in flight, or the whole
weight's share of an SM where the weight is smaller.
"""

import numpy as np
import pytest
import torch

from tony_tpu_torch.ops import adamw as adw
from tony_tpu_torch.ops import quant as q8

H100_SMS = 132
# Qwen2.5-1.5B's seven projections have four (k, n) shapes
PROJ = {"q/o": (1536, 1536), "k/v": (1536, 256), "wg/wi": (1536, 8960),
        "wo": (8960, 1536)}
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,dtype,route", [
    (1, BF16, q8.DECODE), (8, BF16, q8.DECODE), (16, FP32, q8.DECODE),
    (16, BF16, q8.DECODE), (17, BF16, q8.TENSOR_CORES),
    (17, FP32, q8.SIMT_TILE), (4096, BF16, q8.TENSOR_CORES),
    (4096, FP32, q8.SIMT_TILE)])
def test_route_by_rows_and_dtype(m, dtype, route):
    assert q8.route_of(m, dtype) == route
    assert q8.plan(m, 8960, 1536, dtype, H100_SMS).route == route


SHAPES = [(m, k, n) for m in (1, 2, 8, 9, 15, 16, 17, 257, 4096)
          for k, n in PROJ.values()] \
    + [(5, 7, 3), (17, 1000, 300), (300, 96, 40), (1, 1000, 300),
       (3, 4097, 129), (1, 0, 64), (64, 100000, 64)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_blocks_cover_every_output_once(m, k, n, dtype):
    p = q8.plan(m, n, k, dtype, H100_SMS)
    bm = m if p.route == q8.DECODE else q8.TILE_M
    bn = q8.DEC_BN if p.route == q8.DECODE else q8.TILE_N
    cols, rows, splits = p.grid
    assert splits == p.splits
    cover = np.zeros((rows * bm, cols * bn), dtype=np.int64)
    for r in range(rows):
        for c in range(cols):
            cover[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn] += 1
    assert (cover[:m, :n] == 1).all()
    if p.route == q8.DECODE:
        assert rows == 1 and m <= q8.DEC_ROWS


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_splits_cover_k_in_whole_stages(m, k, n, dtype):
    p = q8.plan(m, n, k, dtype, H100_SMS)
    stage = q8.DEC_BK if p.route == q8.DECODE else q8.TILE_K
    assert p.kps > 0 and p.kps % stage == 0
    # every split starts inside k (none empty), and the last reaches it
    assert (p.splits - 1) * p.kps < max(k, 1) <= p.splits * p.kps
    if p.route == q8.DECODE:  # the splits of a slab make one cluster
        assert p.splits <= q8.DEC_MAX_SPLITS


@pytest.mark.parametrize("m,k,n", [s for s in SHAPES if s[0] <= 16])
def test_decode_splits_take_every_stage_once(m, k, n):
    """Split z of S takes stages z, z + S, ...: together every stage of k
    once, none more than the plan's longest split (kps rows)."""
    p = q8.plan(m, n, k, BF16, H100_SMS)
    taken = [j for z in range(p.splits)
             for j in q8.split_stages(z, p.splits, k)]
    assert sorted(taken) == list(range(-(-k // q8.DEC_BK)))
    assert all(len(q8.split_stages(z, p.splits, k)) * q8.DEC_BK <= p.kps
               for z in range(p.splits))


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("proj", sorted(PROJ))
def test_decode_keeps_enough_bytes_in_flight(m, proj):
    """At the decode calls every SM holds IN_FLIGHT_BYTES of weight loads
    in flight (DEC_STAGES - 1 stages a block), or the whole weight's
    share of an SM when the weight is smaller than that (q/o and k/v:
    every stage of every block is in flight at once)."""
    k, n = PROJ[proj]
    p = q8.plan(m, n, k, BF16, H100_SMS)
    blocks = p.grid[0] * p.splits
    per_sm = blocks * q8.decode_in_flight(p.kps) / H100_SMS
    share = k * n / H100_SMS
    assert per_sm >= min(q8.IN_FLIGHT_BYTES, 0.99 * share), (p, per_sm)


def test_decode_call_plans():
    """The plans at Qwen2.5-1.5B's decode shapes on an H100, pinned: wg/wi
    in 5 splits of 320 rows (350 blocks, 2.65 an SM), wo in 16 of 576,
    q/o and k/v in 12 of 128."""
    def grid(proj):
        k, n = PROJ[proj]
        return q8.plan(8, n, k, BF16, H100_SMS)[1:]
    assert grid("wg/wi") == ((70, 1, 5), 5, 320)
    assert grid("wo") == ((12, 1, 16), 16, 576)
    assert grid("q/o") == ((12, 1, 12), 12, 128)
    assert grid("k/v") == ((2, 1, 12), 12, 128)


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("proj", sorted(PROJ))
def test_decode_grid_is_one_wave(m, proj):
    """At the decode shapes the blocks fit on the card at once
    (DEC_BLOCKS_PER_SM an SM) in clusters of at most DEC_MAX_SPLITS."""
    k, n = PROJ[proj]
    p = q8.plan(m, n, k, BF16, H100_SMS)
    assert p.grid[0] * p.splits <= q8.DEC_BLOCKS_PER_SM * H100_SMS
    assert p.splits <= q8.DEC_MAX_SPLITS


def test_prefill_call_takes_one_split():
    p = q8.plan(4096, 8960, 1536, BF16, H100_SMS)
    assert p.grid == (70, 32, 1) and p.kps == 1536


@pytest.mark.parametrize("sms", [1, 66, 114, 132, 144])
def test_decode_splits_follow_the_sm_count(sms):
    """wg/wi's 70 slabs take as many splits as fill DEC_BLOCKS_PER_SM
    blocks an SM, but at least one."""
    p = q8.plan(8, 8960, 1536, BF16, sms)
    want = max(1, q8.DEC_BLOCKS_PER_SM * sms // 70)
    assert p.splits <= want and p.grid[0] * p.splits <= max(
        70, q8.DEC_BLOCKS_PER_SM * sms)
    assert p.splits >= want // 2


# ------------------------------------------------------------ fused AdamW


@pytest.mark.parametrize("arrays,head", [
    ([(256, 4), (512, 4), (1024, 2)], 0),
    ([(260, 4), (514, 2), (1028, 4)], 3),   # every array one element in
    ([(264, 4), (516, 2)], 2),
    ([(268, 4), (518, 2)], 1),
    ([(260, 4), (512, 4)], -1),             # misaligned against each other
    ([(258, 2), (256, 4)], -1),
    ([(257, 4)], -1),                       # not on an element boundary
])
def test_vector_head_by_alignment(arrays, head):
    assert adw.vector_head(arrays) == head


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 65535, 65536, 65537,
                               65539, 3 * 65536 + 5, 200003])
@pytest.mark.parametrize("head", [-1, 0, 1, 2, 3])
def test_chunks_cover_every_element_once(n, head):
    """Every element of a leaf lies in exactly one chunk, every vector
    starts on a VEC-element boundary past the head, and only a leaf's
    first chunk has a scalar head and only its last a scalar tail."""
    leaf_of, offset = adw.chunk_table([n], [head])
    assert (leaf_of == 0).all()
    cover = np.zeros(n, dtype=np.int64)
    spans = [adw.chunk_span(int(o), head, n) for o in offset]
    for j, (start, vs, nv, end) in enumerate(spans):
        cover[start:end] += 1
        assert start <= vs and vs + nv * adw.VEC <= max(end, vs)
        if head < 0:
            assert nv == 0
        else:
            assert (vs - head) % adw.VEC == 0
            if j > 0:
                assert vs == start
            if j < len(spans) - 1:
                assert vs + nv * adw.VEC == end
    assert (cover == 1).all()
    assert len(spans) == (0 if n == 0 else max(
        1, -(-(n - max(head, 0)) // adw.CHUNK)))


def test_chunk_table_over_several_leaves():
    sizes, heads = [1, 65536 * 2 + 7, 0, 5, 65536], [0, 3, -1, -1, 0]
    leaf_of, offset = adw.chunk_table(sizes, heads)
    assert leaf_of.tolist() == [0, 1, 1, 1, 3, 4]
    assert offset.tolist() == [0, 0, 65536, 131072, 0, 0]


def test_vector_bodies_are_most_of_a_large_leaf():
    """The Qwen2.5-1.5B embedding, aligned: all but nothing in vectors."""
    n = 151936 * 1536
    leaf_of, offset = adw.chunk_table([n], [0])
    vec = sum(adw.chunk_span(int(o), 0, n)[2] for o in offset) * adw.VEC
    assert vec == n


@pytest.mark.parametrize("which", [0, 2, 3, 4])  # grad, mu, nu, copy
def test_table_key_holds_every_arrays_shape(which):
    """A cached device table is found again only for arrays of the shapes
    that were checked when it was built: an array shortened by a view at
    the same address (same pointer, same param size) gives another key,
    so the table's check runs again rather than launching with the
    param's size over a shorter array."""
    n = 4099
    leaf = [torch.zeros(n) for _ in range(5)]
    group = [tuple(leaf)]
    key, words = adw.table_key(("dtypes",), group)
    assert key == adw.table_key(("dtypes",), [tuple(leaf)])[0]
    assert words == ((leaf[0].data_ptr(), leaf[1].data_ptr(),
                      leaf[2].data_ptr(), leaf[3].data_ptr(),
                      leaf[4].data_ptr(), n),)
    short = list(leaf)
    short[which] = leaf[which][:n - 4]
    assert short[which].data_ptr() == leaf[which].data_ptr()
    key2, words2 = adw.table_key(("dtypes",), [tuple(short)])
    assert words2 == words and key2 != key


# the expert-batched form (q8_matmul_experts): Mixtral-8x7B's experts,
# E = 8, hidden 4096, FFN 14336
MIXTRAL = {"wi/wg": (4096, 14336), "wo": (14336, 4096)}


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_one_expert_plans_as_one_matrix(m, k, n, dtype):
    assert q8.plan(m, n, k, dtype, H100_SMS, 1) \
        == q8.plan(m, n, k, dtype, H100_SMS)


@pytest.mark.parametrize("experts", [2, 8, 64])
@pytest.mark.parametrize("m,k,n", [s for s in SHAPES if s[0] <= 16]
                         + [(8, *MIXTRAL["wi/wg"]), (8, *MIXTRAL["wo"])])
def test_decode_wave_is_shared_over_the_experts(experts, m, k, n):
    """On the decode route the blocks of all experts fit on the card at
    once (DEC_BLOCKS_PER_SM an SM), unless one split a slab is already
    more than that; the splits still cover k once and stay one
    cluster."""
    p = q8.plan(m, n, k, BF16, H100_SMS, experts)
    blocks = p.grid[0] * p.splits * experts
    assert p.splits == 1 or blocks <= q8.DEC_BLOCKS_PER_SM * H100_SMS
    assert p.splits <= q8.DEC_MAX_SPLITS
    taken = [j for z in range(p.splits)
             for j in q8.split_stages(z, p.splits, k)]
    assert sorted(taken) == list(range(-(-k // q8.DEC_BK)))
    assert p.splits <= q8.plan(m, n, k, BF16, H100_SMS).splits


@pytest.mark.parametrize("experts", [2, 8])
@pytest.mark.parametrize("m", [17, 512, 4096])
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_tile_routes_split_k_for_all_experts_tiles(experts, m, dtype):
    """Routes 1 and 2 count every expert's tiles when they decide the
    K split: a split only where all experts' tiles together leave the
    card less than two blocks an SM."""
    k, n = MIXTRAL["wi/wg"]
    p = q8.plan(m, n, k, dtype, H100_SMS, experts)
    tiles = -(-m // q8.TILE_M) * -(-n // q8.TILE_N) * experts
    assert p.splits == 1 or tiles < 2 * H100_SMS
    assert p.kps % q8.TILE_K == 0
    assert (p.splits - 1) * p.kps < k <= p.splits * p.kps


def test_mixtral_expert_call_plans():
    """The plans at Mixtral-8x7B's expert calls on an H100, pinned: at
    decode (T = 8) one split a slab, 112 x 8 = 896 blocks for wi/wg and
    32 x 8 = 256 for wo; at prefill (T = 512) the tensor cores in 112 x
    4 (wi/wg) and 32 x 4 (wo) tiles an expert, no split."""
    def plan(m, proj):
        k, n = MIXTRAL[proj]
        return q8.plan(m, n, k, BF16, H100_SMS, 8)
    assert plan(8, "wi/wg") == (q8.DECODE, (112, 1, 1), 1, 4096)
    assert plan(8, "wo") == (q8.DECODE, (32, 1, 1), 1, 14336)
    assert plan(512, "wi/wg") == (q8.TENSOR_CORES, (112, 4, 1), 1, 4096)
    assert plan(512, "wo") == (q8.TENSOR_CORES, (32, 4, 1), 1, 14336)

"""The flash-decode wrapper's split rule, a pure function of the call's
shape and the card's SM count (``tony_tpu_torch.ops.decode``): no kernel
runs, so these hold on the CPU.

The rule: a tensor-core block keeps STAGES tiles of K and V (and their
int8 scales) in flight, an SM needs IN_FLIGHT_BYTES of such loads, so an
SM takes ceil(IN_FLIGHT_BYTES / block_bytes) blocks; the SIMT route keeps
two blocks an SM. Either way no split is shorter than one tile of the
longest visible range.
"""

import pytest
import torch

from tony_tpu_torch.ops import decode as dec

H100_SMS = 132


def _old_rule(b, kvh, extent, sms):
    """The SIMT route's rule as it stood: about two blocks per SM."""
    want = -(-2 * sms // max(1, b * kvh))
    return max(1, min(want, -(-extent // dec.TILE_KEYS)))


@pytest.mark.parametrize("kv_dtype,d,nbytes", [
    (torch.bfloat16, 128, dec.STAGES * 2 * 64 * 128 * 2),
    (torch.int8, 128, dec.STAGES * (2 * 64 * 128 + 2 * 64 * 4)),
    (torch.bfloat16, 64, dec.STAGES * 2 * 64 * 64 * 2),
])
def test_block_bytes(kv_dtype, d, nbytes):
    assert dec.block_bytes(kv_dtype, d) == nbytes


def test_serve_call_splits():
    """Qwen2.5-1.5B at batch 8 (KVH 2) over a 4096-position cache: a bf16
    block keeps 64 KiB in flight, so one block an SM (132 blocks over 16
    (row, KV head) pairs: 9 splits); an int8 block keeps about half that,
    so two (17 splits)."""
    bf16 = dec.block_bytes(torch.bfloat16, 128)
    int8 = dec.block_bytes(torch.int8, 128)
    assert dec.n_splits(8, 2, 4096, H100_SMS, bf16) == 9
    assert dec.n_splits(8, 2, 4096, H100_SMS, int8) == 17
    # the blocks then cover the SMs at least once, and not twice over
    for per, nbytes in ((1, bf16), (2, int8)):
        n = dec.n_splits(8, 2, 4096, H100_SMS, nbytes)
        assert per * H100_SMS <= 16 * n < per * H100_SMS + 16


@pytest.mark.parametrize("b,kvh,extent", [
    (8, 2, 4096), (8, 2, 64), (8, 12, 1024), (1, 1, 100), (64, 8, 4096),
    (3, 2, 1), (200, 1, 8192)])
def test_simt_rule_is_unchanged(b, kvh, extent):
    assert dec.n_splits(b, kvh, extent, H100_SMS) == \
        _old_rule(b, kvh, extent, H100_SMS)


@pytest.mark.parametrize("extent,cap", [(1, 1), (64, 1), (65, 2),
                                        (130, 3), (4096, 64)])
def test_no_split_shorter_than_a_tile(extent, cap):
    """One (row, KV head) pair would want 132 splits; the visible range
    caps them at one tile each."""
    nbytes = dec.block_bytes(torch.bfloat16, 128)
    assert dec.n_splits(1, 1, extent, H100_SMS, nbytes) == min(cap, 132)


def test_more_pairs_than_sms_take_one_split():
    nbytes = dec.block_bytes(torch.bfloat16, 128)
    assert dec.n_splits(64, 8, 4096, H100_SMS, nbytes) == 1
    assert dec.n_splits(200, 1, 4096, H100_SMS) == 2


def test_m_tiles_share_the_blocks():
    """A query group past 16 rows takes a block per 16: the splits fall
    as the m-tiles multiply the blocks."""
    nbytes = dec.block_bytes(torch.bfloat16, 128)
    one = dec.n_splits(4, 2, 4096, H100_SMS, nbytes)
    two = dec.n_splits(4, 2, 4096, H100_SMS, nbytes, mtiles=2)
    assert (one, two) == (17, 9)


@pytest.mark.parametrize("sms", [1, 66, 114, 132, 144])
def test_splits_follow_the_sm_count(sms):
    nbytes = dec.block_bytes(torch.bfloat16, 128)
    n = dec.n_splits(8, 2, 1 << 20, sms, nbytes)
    assert n == -(-sms // 16)

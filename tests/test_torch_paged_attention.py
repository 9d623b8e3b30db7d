"""Paged decode of the PyTorch port (elastic_tpu_agent_torch/workloads/
paged_attention.py): its plain version against the JAX package's Pallas
kernel in interpret mode, over random block tables and lengths (a row of
length 0 included). float32; tolerance 1e-5 (summation order). Also the
host side of the Hopper kernel: its split policy and cut, and its traffic
model."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import paged_attention as jpa  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    paged_attention as tpa,
)


def _random_case(rng, slots, g, r, h, bs, n_blocks, nb):
    q = rng.normal(size=(slots, g * r, h)).astype(np.float32)
    pk = rng.normal(size=(n_blocks, bs, g, h)).astype(np.float32)
    pv = rng.normal(size=(n_blocks, bs, g, h)).astype(np.float32)
    table = np.zeros((slots, nb), np.int32)
    lengths = np.zeros((slots,), np.int32)
    pool_ids = rng.permutation(np.arange(1, n_blocks))
    cursor = 0
    for s in range(slots):
        used = int(rng.integers(1, nb + 1))
        table[s, :used] = pool_ids[cursor:cursor + used]
        cursor += used
        lengths[s] = int(rng.integers(1, used * bs + 1))
    return q, pk, pv, table, lengths


def _both(q, pk, pv, table, lengths, g, window=0):
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lengths), g, interpret=True,
        window=window,
    )
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, pk, pv, table, lengths)), g,
        window=window,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("g,r", [(2, 2), (4, 1), (1, 4)])
def test_plain_matches_pallas_random_tables(g, r):
    rng = np.random.default_rng(3)
    case = _random_case(rng, 4, g, r, 8, 4, 24, 6)
    got, want = _both(*case, g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_plain_window_mask_matches_pallas():
    rng = np.random.default_rng(9)
    slots, g, r, h, bs, n_blocks = 2, 2, 2, 8, 4, 12
    q = rng.normal(size=(slots, g * r, h)).astype(np.float32)
    pk = rng.normal(size=(n_blocks, bs, g, h)).astype(np.float32)
    pv = rng.normal(size=(n_blocks, bs, g, h)).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    lengths = np.asarray([14, 6], np.int32)
    for window in (3, 8):
        got, want = _both(q, pk, pv, table, lengths, g, window=window)
        np.testing.assert_allclose(
            got, want, atol=1e-5, rtol=1e-5, err_msg=f"window={window}"
        )


def test_plain_length_zero_row_matches_pallas():
    """A row of length 0 attends nothing; the Pallas kernel then takes every
    score as NEG_INF and returns the mean of V over the row's whole table
    (junk block 0 included), and so must the port."""
    rng = np.random.default_rng(11)
    q, pk, pv, table, lengths = _random_case(rng, 4, 2, 2, 8, 4, 24, 6)
    lengths[1] = 0
    got, want = _both(q, pk, pv, table, lengths, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    mean_v = pv[table[1]].reshape(-1, 2, 8).mean(0)        # [g, h]
    np.testing.assert_allclose(
        got[1], np.repeat(mean_v, 2, axis=0), atol=1e-5, rtol=1e-5
    )
    for window in (3,):
        got, want = _both(q, pk, pv, table, lengths, 2, window=window)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _attended_blocks(length, nb, bs, window):
    if length == 0:
        return set(range(nb))
    pos = [p for p in range(min(length, nb * bs))
           if window <= 0 or length - 1 - p < window]
    return {p // bs for p in pos}


def test_split_ranges_cover_each_attended_block_once():
    rng = np.random.default_rng(12)
    for _ in range(400):
        nb = int(rng.integers(1, 40))
        bs = int(rng.choice([1, 4, 16, 64]))
        length = int(rng.integers(0, nb * bs + 1))
        window = int(rng.choice([0, 0, 1, 7, 37, 100]))
        splits = int(rng.integers(1, 12))
        ranges = tpa.paged_split_ranges(length, nb, bs, window, splits)
        assert len(ranges) == splits
        seen = [j for b0, b1 in ranges for j in range(b0, b1)]
        assert len(seen) == len(set(seen))              # each block once
        assert set(seen) == _attended_blocks(length, nb, bs, window)
        assert seen == sorted(seen)                     # contiguous, in order
        sizes = [b1 - b0 for b0, b1 in ranges]
        assert sizes == sorted(sizes, reverse=True)     # the last ones short


def test_split_policy_fills_the_card():
    # the serving shape: 8 slots x 8 kv heads x 4 splits ~ 2 CTAs per SM
    assert tpa.paged_splits(8, 8, 32) == 4
    assert tpa.paged_splits(8, 2, 32) == 16
    assert tpa.paged_splits(8, 8, 1) == 1                # one table block
    assert tpa.paged_splits(1, 1, 5000, sm_count=132) == 264
    for slots, g, nb in ((1, 1, 100_000), (64, 8, 3000), (200, 8, 16)):
        splits = tpa.paged_splits(slots, g, nb)
        assert 1 <= splits <= max(1, nb)
        assert -(-nb // splits) <= tpa.MAX_SPLIT_BLOCKS


def test_wrapper_checks_shapes():
    q = torch.zeros((2, 4, 8))
    pool = torch.zeros((5, 4, 2, 8))
    table = torch.zeros((2, 3), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    out = tpa.paged_decode_attention(q, pool, pool, table, lengths, 2)
    assert out.shape == q.shape
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q, pool, pool, table, lengths, 3)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q, pool, pool, table[:1], lengths, 2)


def test_kernel_traffic_counts_attended_positions():
    # full table: every position of every block, K and V, each once
    full = tpa.kernel_traffic(8, 32, 16, 8, 64, 2, n_heads=8)
    assert full["grid"] == (8, 8, 4)
    assert full["positions_attended"] == 8 * 512
    assert full["kv_bytes_read"] == 8 * 512 * 8 * 64 * 2 * 2
    assert full["blocks_streamed"] == 8 * 32 * 8
    assert full["flops"] == 4 * 8 * 512 * 8 * 64
    # the function's bytes: K/V, q and out once, lengths and the table
    # entries it needs; the partials' f32 (m, l, acc[h]) write and
    # read-back come on top in what the two launches move
    qo = 8 * 8 * 64 * 2
    assert full["bytes"] == full["kv_bytes_read"] + 2 * qo + 8 * 4 + 256 * 4
    assert full["partial_bytes"] == 2 * 8 * 8 * 4 * 66 * 4
    assert full["kernel_bytes"] == (full["kv_bytes_read"] + 5 * qo
                                    + (8 * 4 + 256) * 8 * 4
                                    + full["partial_bytes"])
    one = tpa.kernel_traffic(8, 32, 16, 8, 64, 2, n_heads=8, splits=1)
    assert one["grid"] == (8, 8, 1) and one["partial_bytes"] == 0
    # a row of length 0 reads its whole table
    assert tpa.kernel_traffic(
        2, 4, 4, 1, 8, 4, lengths=[0, 5]
    )["positions_attended"] == 16 + 5
    # lengths stop the stream; a window starts it late
    t = tpa.kernel_traffic(
        2, 4, 4, 1, 8, 4, n_heads=2, lengths=[5, 16], window=6
    )
    assert t["positions_attended"] == 5 + 6
    assert t["blocks_streamed"] == 2 + 2       # blocks 0-1 and 2-3
    assert t["kv_bytes_read"] == 11 * 8 * 4 * 2
    # a length past the table is clamped to it
    assert tpa.kernel_traffic(
        1, 2, 4, 1, 8, 4, lengths=[100]
    )["positions_attended"] == 8

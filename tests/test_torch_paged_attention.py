"""Paged decode of the PyTorch port (elastic_tpu_agent_torch/workloads/
paged_attention.py): its plain version against the JAX package's Pallas
kernel in interpret mode, over random block tables and lengths. float32;
tolerance 1e-5 (summation order)."""

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
    assert full["grid"] == (8, 8)
    assert full["positions_attended"] == 8 * 512
    assert full["kv_bytes_read"] == 8 * 512 * 8 * 64 * 2 * 2
    assert full["blocks_streamed"] == 8 * 32 * 8
    assert full["flops"] == 4 * 8 * 512 * 8 * 64
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

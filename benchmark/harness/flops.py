"""Operations and bytes that the work needs, from shapes alone.

Model FLOPs count each multiply-add as two operations: 2N a token for the
matrix products of a forward (N the parameters without the embedding and
position tables, the output head counted), 6N a token for a training step
(forward and backward), and attention's two products (scores and the
weighted sum, 4 n h a query and attended key) over the keys each query
attends: all earlier positions under a causal mask, at most ``window`` of
them under a sliding window. A backward of attention needs five products
(the scores again, dP, dV, dK, dQ) where the forward needs two, 2.5 times
its operations (FlashAttention-2, Dao 2023, section 3.1.2). Nothing is
counted for padding, recomputation or the kernels' own extra passes."""

from __future__ import annotations


def attended_keys(seq: int, window: int = 0) -> int:
    """Sum over the ``seq`` queries of a causal (windowed) row of the keys
    each attends, itself included."""
    if window <= 0 or seq <= window:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_fwd_flops(batch: int, n_heads: int, head_dim: int, seq: int,
                        window: int = 0) -> int:
    return 4 * batch * n_heads * head_dim * attended_keys(seq, window)


def prefill_flops(s: dict, non_embedding: int, prompt: int) -> int:
    """A forward over one prompt of ``prompt`` tokens (unpadded)."""
    attn = s["layers"] * attention_fwd_flops(1, s["n"], s["h"], prompt,
                                             s["window"])
    return 2 * non_embedding * prompt + attn


def decode_step_flops(s: dict, non_embedding: int, lengths) -> int:
    """A decode step: one new token for each live row, which attends the
    row's ``lengths`` positions (its own write included)."""
    attn = sum(s["layers"] * 4 * s["n"] * s["h"]
               * (min(n, s["window"]) if s["window"] > 0 else n)
               for n in lengths)
    return 2 * non_embedding * len(lengths) + attn


def train_step_flops(s: dict, non_embedding: int, batch: int,
                     seq: int) -> int:
    """A training step over ``batch`` rows of ``seq`` positions."""
    attn = 3 * s["layers"] * attention_fwd_flops(batch, s["n"], s["h"], seq,
                                                 s["window"])
    return 6 * non_embedding * batch * seq + attn


def flash_fwd_traffic(batch: int, n_heads: int, kv_heads: int,
                      head_dim: int, seq: int, itemsize: int,
                      window: int = 0) -> dict:
    """One causal forward call: q, k, v read once, o and the f32 lse
    written once."""
    b, n, g, h, s = batch, n_heads, kv_heads, head_dim, seq
    nbytes = (2 * b * s * n * h + 2 * b * s * g * h) * itemsize + b * n * s * 4
    return dict(flops=attention_fwd_flops(b, n, h, s, window), bytes=nbytes)


def flash_bwd_traffic(batch: int, n_heads: int, kv_heads: int,
                      head_dim: int, seq: int, itemsize: int,
                      window: int = 0) -> dict:
    """One causal backward (dK/dV and dQ together): q, k, v, dO, the f32
    lse and delta read once, dq, dk, dv written once."""
    b, n, g, h, s = batch, n_heads, kv_heads, head_dim, seq
    reads = (2 * b * s * n * h + 2 * b * s * g * h) * itemsize + 2 * b * n * s * 4
    writes = (b * s * n * h + 2 * b * s * g * h) * itemsize
    flops = 5 * attention_fwd_flops(b, n, h, s, window) // 2
    return dict(flops=flops, bytes=reads + writes)

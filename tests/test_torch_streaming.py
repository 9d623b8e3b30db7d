"""Streaming ring-cache decode of the PyTorch port (elastic_tpu_agent_torch/
workloads/streaming.py) against the JAX package: with a cache of exactly
``window`` slots the stream equals JAX's streaming stream and the port's
full-cache windowed decode, across many ring wraps, MHA and GQA; the
cache stays window-sized however long the stream; bad configs raise as
JAX's do. float32 weights bridged from a JAX init_params tree."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import streaming as jstream  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import streaming as tstream  # noqa: E402,E501
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

# the packages re-export the function `generate`, which shadows the module
tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64,
            pos="rope", window=8)


def _models(**kw):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, **kw)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_stream_token_exact_vs_jax(kv_heads):
    """30 new tokens after a 5-token prompt: 35 positions, over four times
    around the 8-slot ring."""
    jcfg, tcfg, tree, params = _models(n_kv_heads=kv_heads)
    prompt = np.random.default_rng(1).integers(0, 97, size=(2, 5))
    want = jstream.streaming_generate(
        tree, jnp.asarray(prompt, jnp.int32), jcfg, max_new_tokens=30)
    got = tstream.streaming_generate(params, prompt, tcfg, 30, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    full = tg.generate(params, prompt, tcfg, 30, device="cpu")
    assert got.tolist() == full.tolist()


def test_stream_cache_stays_window_sized(monkeypatch):
    """400 tokens through the 8-slot ring: the one cache allocated is
    [L, b, window, g, h], and the stream equals the full-cache decode."""
    _, tcfg, _, params = _models()
    shapes = []
    real = tg.KVCache.empty.__func__

    def empty(cls, cfg, batch, max_len, dtype=None, device="cuda"):
        cache = real(cls, cfg, batch, max_len, dtype, device)
        shapes.append(tuple(cache.k.shape))
        return cache

    monkeypatch.setattr(tstream.KVCache, "empty", classmethod(empty))
    prompt = np.random.default_rng(2).integers(0, 97, size=(1, 8))
    got = tstream.streaming_generate(params, prompt, tcfg, 400, device="cpu")
    assert shapes == [(2, 1, 8, 4, 8)]
    monkeypatch.undo()
    want = tg.generate(params, prompt, tcfg, 400, max_len=408, device="cpu")
    assert got.shape == (1, 408) and got.tolist() == want.tolist()


def test_stream_sampling_deterministic_per_generator():
    _, tcfg, _, params = _models()
    prompt = np.random.default_rng(3).integers(0, 97, size=(2, 4))

    def run():
        gen = torch.Generator().manual_seed(7)
        return tstream.streaming_generate(
            params, prompt, tcfg, 20, temperature=0.8, top_k=10,
            generator=gen, device="cpu").tolist()

    out = run()
    assert out == run() and np.asarray(out)[:, :4].tolist() == prompt.tolist()
    assert tstream.streaming_generate(
        params, prompt, tcfg, 0, device="cpu").tolist() == prompt.tolist()


@pytest.mark.parametrize(
    "kw,prompt_len,match",
    [(dict(window=0), 4, "sliding-window"),
     (dict(pos="learned"), 4, "rope"),
     ({}, 9, "fit the attention window")],
    ids=["full-attention", "learned", "prompt-too-long"],
)
def test_stream_rejects_bad_configs_as_jax(kw, prompt_len, match):
    jcfg, tcfg, tree, params = _models()
    prompt = np.zeros((1, prompt_len), np.int32)
    with pytest.raises(AssertionError, match=match):
        jstream.streaming_generate(
            tree, jnp.asarray(prompt), jt.ModelConfig(
                **{**BASE, **kw}, dtype=jnp.float32, attn="reference"), 4)
    with pytest.raises(ValueError, match=match):
        tstream.streaming_generate(
            params, prompt, tt.ModelConfig(
                **{**BASE, **kw}, dtype=torch.float32), 4, device="cpu")


def test_ring_chunk_takes_one_token_without_positions():
    _, tcfg, _, params = _models()
    cache = tg.KVCache.empty(tcfg, 1, 8, device="cpu")
    ring = (0, torch.zeros(8, dtype=torch.long))
    with pytest.raises(ValueError, match="one token per call"):
        tg._forward_chunk(params, torch.zeros((1, 2), dtype=torch.long),
                          cache, tcfg, ring=ring)
    with pytest.raises(ValueError, match="one token per call"):
        tg._forward_chunk(params, torch.zeros((1, 1), dtype=torch.long),
                          cache, tcfg, positions=torch.zeros(1), ring=ring)

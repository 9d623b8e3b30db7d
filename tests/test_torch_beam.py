"""Beam search of the PyTorch port (elastic_tpu_agent_torch/workloads/
beam.py) against the JAX package: sequences exact and scores within 1e-5
of JAX's on the same bridged float32 weights, with eos freezing and GNMT
length normalisation; beam 1 is greedy decoding; the edge cases."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import beam as jbeam  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import beam as tbeam  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=64,
            pos="rope")


@pytest.fixture(scope="module")
def models():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize(
    "beam,alpha,eos_at,n",
    [(4, 0.0, None, 8), (3, 0.6, 1, 6), (3, 0.0, 1, 10)],
    ids=["beam4", "beam3-eos-penalty", "beam3-eos"],
)
def test_beam_exact_vs_jax(models, beam, alpha, eos_at, n):
    """eos_at: eos is the token greedy decoding emits at that generated
    position, so hypotheses finish early and freeze."""
    jcfg, tcfg, tree, params = models
    prompt = np.random.default_rng(beam + n).integers(0, 97, size=(1, 5))
    eos = None
    if eos_at is not None:
        eos = int(tg.generate(params, prompt, tcfg, n, device="cpu")[
            0, 5 + eos_at])
    want_seqs, want_scores = jbeam.beam_search(
        tree, jnp.asarray(prompt, jnp.int32), jcfg, max_new_tokens=n,
        beam_size=beam, length_penalty=alpha, eos_id=eos)
    seqs, scores = tbeam.beam_search(
        params, prompt, tcfg, n, beam_size=beam, length_penalty=alpha,
        eos_id=eos, device="cpu")
    assert seqs.tolist() == np.asarray(want_seqs).tolist()
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=1e-5, rtol=0)
    s = scores.numpy()
    assert (s[:-1] >= s[1:]).all()
    if eos is not None:
        hit = False
        for row in seqs[:, 5:].tolist():
            if eos in row:
                hit = True
                assert set(row[row.index(eos):]) == {eos}, row
        assert hit


def test_beam_one_is_greedy(models):
    jcfg, tcfg, tree, params = models
    prompt = np.random.default_rng(1).integers(0, 97, size=(1, 6))
    seqs, scores = tbeam.beam_search(params, prompt, tcfg, 10, beam_size=1,
                                     device="cpu")
    want = tg.generate(params, prompt, tcfg, 10, device="cpu")
    assert seqs.tolist() == want.tolist()
    # the score is the sequence's teacher-forced logprob
    logp = torch.log_softmax(
        tt.forward(params, seqs[:, :-1], tcfg, device="cpu")[0].float(), -1)
    lp = logp[torch.arange(5, 15), seqs[0, 6:]].sum()
    assert abs(float(scores[0]) - float(lp)) < 1e-4


def test_beam_edge_cases(models):
    _, tcfg, _, params = models
    prompt = [[3, 1, 4]]
    seqs, scores = tbeam.beam_search(params, prompt, tcfg, 0, beam_size=3,
                                     device="cpu")
    assert seqs.tolist() == [[3, 1, 4]] * 3 and scores.tolist() == [0.0] * 3
    with pytest.raises(ValueError, match="ONE prompt"):
        tbeam.beam_search(params, [[1, 2], [3, 4]], tcfg, 4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tbeam.beam_search(params, prompt, tcfg, 8, max_len=9, device="cpu")


def test_top_k_ties_take_the_lower_index_first():
    x = torch.tensor([0.5, 2.0, 1.0, 2.0, 1.0, 2.0])
    values, idx = tbeam._top_k(x, 4)
    assert idx.tolist() == [1, 3, 5, 2] and values.tolist() == [2, 2, 2, 1]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 4)[1]
    assert idx.tolist() == np.asarray(want).tolist()

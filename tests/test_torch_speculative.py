"""Speculative decoding of the PyTorch port (elastic_tpu_agent_torch/
workloads/speculative.py) against the JAX package: greedy streams and
SpecStats equal JAX's on the same bridged float32 weights (gamma 1, 3 and
5, learned and rope positions, a window model) and equal greedy
generate(); the accept/resample algebra, given its uniforms, equals a
numpy transcription of the JAX round; sampling keeps the target's
distribution (total-variation probe)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import speculative as jspec  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import speculative as tspec  # noqa: E402,E501
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

TARGET = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=128)
DRAFT = dict(vocab=97, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_seq=128)


def _pair(**kw):
    jcfg = jt.ModelConfig(**TARGET, dtype=jnp.float32, attn="reference", **kw)
    jdcfg = jt.ModelConfig(**DRAFT, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**TARGET, dtype=torch.float32, **kw)
    tdcfg = tt.ModelConfig(**DRAFT, dtype=torch.float32, **kw)
    tree = jt.init_params(jcfg, jax.random.key(0))
    dtree = jt.init_params(jdcfg, jax.random.key(1))
    return ((jcfg, jdcfg, tree, dtree),
            (tcfg, tdcfg, params_from_jax(tree, tcfg, device="cpu"),
             params_from_jax(dtree, tdcfg, device="cpu")))


@pytest.mark.parametrize(
    "gamma,kw",
    [(1, dict(pos="learned")), (3, dict(pos="rope")),
     (5, dict(pos="learned")), (3, dict(pos="rope", window=8))],
    ids=["g1-learned", "g3-rope", "g5-learned", "g3-rope-window8"],
)
def test_greedy_stream_and_stats_equal_jax(gamma, kw):
    (jcfg, jdcfg, tree, dtree), (tcfg, tdcfg, params, dparams) = _pair(**kw)
    prompt = np.random.default_rng(gamma).integers(0, 97, size=(1, 7))
    n = 24
    want, jstats = jspec.speculative_generate(
        tree, dtree, jcfg, jdcfg, jnp.asarray(prompt, jnp.int32),
        max_new_tokens=n, gamma=gamma)
    got, stats = tspec.speculative_generate(
        params, dparams, tcfg, tdcfg, prompt, n, gamma=gamma, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert stats.stats() == jstats.stats()
    assert stats.rounds >= 1 and 0 <= stats.accepted <= stats.drafted
    oracle = tg.generate(params, prompt, tcfg, n,
                         max_len=7 + n + gamma + 1, device="cpu")
    assert got.tolist() == oracle.tolist()


def test_draft_equals_target_accepts_everything():
    """Draft == target: every proposal survives, so rounds = ceil(N /
    (gamma + 1)) and accepted == drafted."""
    _, (tcfg, _, params, _) = _pair(pos="rope")
    prompt = np.random.default_rng(2).integers(0, 97, size=(1, 5))
    n, gamma = 24, 3
    got, stats = tspec.speculative_generate(
        params, params, tcfg, tcfg, prompt, n, gamma=gamma, device="cpu")
    assert stats.accepted == stats.drafted
    assert stats.rounds == -(-n // (gamma + 1))
    assert stats.stats()["acceptance_rate"] == 1.0
    want = tg.generate(params, prompt, tcfg, n, device="cpu")
    assert got.tolist() == want.tolist()


def _accept_np(target_p, draft_q, draft_toks, u, u_corr):
    """speculative.py's round (accept, residual, correction), one row at
    a time in numpy; the correction is the Gumbel-max draw over u_corr."""
    gamma = draft_toks.shape[0]
    p_i = target_p[np.arange(gamma), draft_toks]
    q_i = draft_q[np.arange(gamma), draft_toks]
    ok = u < np.minimum(1.0, p_i / np.maximum(q_i, 1e-30))
    n_acc = int(np.sum(np.cumprod(ok.astype(np.int32))))
    cut = min(n_acc, gamma - 1)
    resid = np.maximum(target_p[cut] - draft_q[cut], 0.0)
    s = resid.sum()
    resid = resid / max(s, 1e-30) if s > 0 else target_p[cut]
    dist = target_p[gamma] if n_acc == gamma else resid
    logits = np.log(np.maximum(dist, 1e-30))
    return n_acc, int(np.argmax(logits - np.log(-np.log(u_corr))))


def test_accept_resample_equals_numpy_transcription():
    """Rows built to take every branch: a rejection at the first draft, a
    partial accept, a full accept with the bonus token, and p == q (no
    residual: the correction comes from p)."""
    rng = np.random.default_rng(0)
    b, gamma, vocab = 6, 3, 11
    target_p = rng.dirichlet(np.ones(vocab), size=(b, gamma + 1))
    draft_q = rng.dirichlet(np.ones(vocab), size=(b, gamma))
    draft_toks = rng.integers(0, vocab, size=(b, gamma))
    u = rng.uniform(0, 1, size=(b, gamma))
    u_corr = rng.uniform(1e-6, 1, size=(b, vocab))
    u[0, 0] = 0.9999                       # row 0: the first draft fails
    target_p[0, 0, draft_toks[0, 0]] = 1e-3
    u[1, :2], u[1, 2] = 0.0, 0.9999        # row 1: two accepted, then out
    target_p[1, 2, draft_toks[1, 2]] = 1e-3
    u[2] = 0.0                             # row 2: all accepted, bonus
    draft_q[3] = target_p[3, :gamma]       # row 3: p == q, all pass
    draft_q[4] = target_p[4, :gamma]       # row 4: p == q, u cannot pass
    u[4, 1] = 1.0                          # ratio 1: u < 1 fails
    target_p = target_p.astype(np.float32)
    draft_q = draft_q.astype(np.float32)
    u, u_corr = u.astype(np.float32), u_corr.astype(np.float32)
    n_acc, corr = tspec.accept_resample(
        *map(torch.from_numpy, (target_p, draft_q, draft_toks, u, u_corr)))
    want = [_accept_np(target_p[i], draft_q[i], draft_toks[i], u[i],
                       u_corr[i]) for i in range(b)]
    assert list(zip(n_acc.tolist(), corr.tolist())) == want
    assert [w[0] for w in want[:5]] == [0, 2, 3, 3, 1]


def test_sampling_deterministic_and_validated():
    _, (tcfg, tdcfg, params, dparams) = _pair()
    prompt = np.random.default_rng(6).integers(0, 97, size=(1, 6))

    def run():
        out, _ = tspec.speculative_generate(
            params, dparams, tcfg, tdcfg, prompt, 12, gamma=2,
            temperature=0.8, generator=torch.Generator().manual_seed(9),
            device="cpu")
        return out

    out = run()
    assert out.shape == (1, 18) and out.tolist() == run().tolist()
    assert out[:, :6].tolist() == prompt.tolist()
    assert 0 <= int(out.min()) and int(out.max()) < 97
    with pytest.raises(ValueError, match="single-stream"):
        tspec.speculative_generate(params, dparams, tcfg, tdcfg,
                                   np.zeros((2, 4)), 4, device="cpu")
    with pytest.raises(ValueError, match="vocabularies"):
        tspec.speculative_generate(
            params, dparams, tcfg, tt.ModelConfig(**{**DRAFT, "vocab": 50}),
            prompt, 4, device="cpu")


def test_sampling_preserves_target_distribution_one_step():
    """For the second new token (the first that a verify round emits),
    the speculative sampler's empirical distribution over 400 seeds is
    within total variation 0.2 of direct sampling from the target, as the
    JAX test holds its sampler; a rule that kept every draft proposal
    lands far above."""
    cfg = dict(vocab=13, d_model=16, n_heads=2, n_layers=1, d_ff=32,
               max_seq=32)
    jcfg = jt.ModelConfig(**cfg, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**cfg, dtype=torch.float32)
    params = params_from_jax(jt.init_params(jcfg, jax.random.key(0)), tcfg,
                             device="cpu")
    draft = params_from_jax(jt.init_params(jcfg, jax.random.key(3)), tcfg,
                            device="cpu")
    prompt = [[1, 4, 7]]
    n = 400

    def spec_tok(seed):
        out, _ = tspec.speculative_generate(
            params, draft, tcfg, tcfg, prompt, 2, gamma=1, temperature=1.0,
            generator=torch.Generator().manual_seed(seed), device="cpu")
        return int(out[0, 4])

    def direct_tok(seed):
        out = tg.generate(params, prompt, tcfg, 2, temperature=1.0,
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")
        return int(out[0, 4])

    spec = np.bincount([spec_tok(s) for s in range(n)], minlength=13) / n
    direct = np.bincount([direct_tok(s + 10_000) for s in range(n)],
                         minlength=13) / n
    tv = 0.5 * np.abs(spec - direct).sum()
    assert tv < 0.2, f"TV distance {tv:.3f}"

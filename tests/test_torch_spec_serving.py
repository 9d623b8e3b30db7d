"""Speculative decoding in the port's serving engine (elastic_tpu_agent_
torch/workloads/serving.py, draft_params=/draft_cfg=/gamma=) against the
JAX engine, mirroring tests/test_spec_serving.py on both engines: churn
(admit and enqueue), draft equal to target, stop-token truncation inside
a round, the max_len fallback (gather path and paged kernel), prefix
admissions (explicit and automatic cache hits), top-k/top-p rejection,
mixed greedy and sampled rows, a randomized soak and constructor
validation. Greedy streams are token-exact with the JAX engine's and with
target-only greedy generate(); stats()["speculative"], the flight records
and the observatory's emitted-token counts equal JAX's. float32 weights
bridged from JAX init_params trees.

The JAX engines compile per engine, so the shared-config scenarios run in
sequence on one engine per side (a module fixture), as one script."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import request_obs as jro  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import telemetry as jtel  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import request_obs as tro  # noqa: E402
from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=128, pos="rope")
DRAFT = dict(vocab=97, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_seq=128, pos="rope")
SHARED = dict(slots=3, max_len=64, prompt_buckets=(4, 8), gamma=3)
SYSTEM = [7, 7, 30, 2, 51, 11, 29, 4]


@pytest.fixture(scope="module")
def models():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference")
    jdcfg = jt.ModelConfig(**DRAFT, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32)
    tdcfg = tt.ModelConfig(**DRAFT, dtype=torch.float32)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    dtree = jax.device_get(jt.init_params(jdcfg, jax.random.key(7)))
    return dict(
        jax=(jcfg, jdcfg, tree, dtree),
        port=(tcfg, tdcfg, params_from_jax(tree, tcfg, device="cpu"),
              params_from_jax(dtree, tdcfg, device="cpu")),
    )


def _engine(side, models, draft="draft", **kw):
    cfg, dcfg, params, dparams = models[side]
    if draft == "target":
        dcfg, dparams = cfg, params
    if side == "jax":
        return js.ServingEngine(params, cfg, draft_params=dparams,
                                draft_cfg=dcfg, **kw)
    return ts.ServingEngine(params, cfg, draft_params=dparams,
                            draft_cfg=dcfg, device="cpu", **kw)


def _oracle(models, prompt, n):
    """Target-only greedy decode, the port's generate() (token-exact with
    JAX's: test_torch_generate.py)."""
    cfg, _, params, _ = models["port"]
    return tg.generate(params, [prompt], cfg, n, device="cpu")[
        0, len(prompt):].tolist()


# -- the shared-engine script ------------------------------------------------


def _churn(eng):
    """Interleaved admissions, a mid-flight join and a chunked admission
    (the enqueue route's draft prefill)."""
    prompts = [[5, 17, 42, 9], [3, 88], [61, 24, 7], [44, 1, 2, 3, 4, 8]]
    rids = [eng.admit(prompts[0]), eng.admit(prompts[1])]
    outs = []
    for _ in range(4):
        outs.append(eng.step())
    rids.append(eng.admit(prompts[2]))
    for _ in range(3):
        outs.append(eng.step())
    streams = [eng.release(rids[0])]
    rids.append(eng.enqueue(prompts[3]))
    for _ in range(5):
        outs.append(eng.step())
    streams += [eng.release(r) for r in rids[1:]]
    return dict(prompts=prompts, streams=streams, outs=outs)


def _prefix(eng):
    """Explicit-prefix admissions (the target shares the prefix blocks,
    the draft recomputes the whole sequence) and an automatic prefix-cache
    hit on the blocks they published."""
    pid = eng.register_prefix(SYSTEM)
    tails = [[5, 17], [61, 3, 9]]
    rids = [eng.admit(t, prefix=pid) for t in tails]
    rids.append(eng.admit(SYSTEM + [5, 17, 23]))
    outs = [eng.step() for _ in range(4)]
    streams = [eng.release(r) for r in rids]
    eng.release_prefix(pid)
    return dict(prompts=[SYSTEM + t for t in tails] + [SYSTEM + [5, 17, 23]],
                streams=streams, outs=outs,
                prefix_cache=eng.stats()["prefix_cache"])


def _reject_topk(eng):
    free = list(eng._free)
    with pytest.raises(ValueError, match="temperature"):
        eng.admit([5, 17], top_k=5)
    with pytest.raises(ValueError, match="temperature"):
        eng.enqueue([5, 17], top_p=0.9)
    assert list(eng._free) == free      # the refused claims gave it back
    rid = eng.admit([5, 17])
    assert rid in eng._slot_of
    eng.step()
    return dict(prompts=[[5, 17]], streams=[eng.release(rid)])


def _mixed(eng):
    pg = [5, 17, 42, 9]
    rg = eng.admit(pg)
    rs = eng.admit([3, 88], temperature=1.2)
    rt = eng.admit([61, 24], temperature=0.7)
    for _ in range(5):
        eng.step()
    sampled = [eng.release(r) for r in (rs, rt)]
    assert all(s and all(0 <= t < 97 for t in s) for s in sampled)
    return dict(prompts=[pg], streams=[eng.release(rg)])


def _soak(eng, iters=40):
    """Churn of greedy and temperature admissions with random release
    budgets (the JAX soak's schedule at fewer iterations)."""
    rng = np.random.default_rng(23)
    pid = eng.register_prefix([7, 30, 2, 9])
    expected, budget, done = {}, {}, []
    for _ in range(iters):
        live = [r for r in budget if budget[r] > 0]
        if eng._free and (not live or rng.random() < 0.4):
            prompt = rng.integers(0, 97, size=int(rng.integers(1, 6))).tolist()
            use_prefix = bool(rng.integers(0, 2))
            greedy = bool(rng.integers(0, 2))
            rid = eng.admit(
                prompt, prefix=pid if use_prefix else None,
                temperature=0.0 if greedy else float(rng.uniform(0.5, 1.3)))
            expected[rid] = (greedy, ([7, 30, 2, 9] if use_prefix else [])
                             + prompt)
            budget[rid] = int(rng.integers(1, 6))
            continue
        if not live:
            continue
        eng.step()
        for r in list(budget):
            if budget[r] > 0 and r in eng._streams:
                budget[r] -= 1
                if budget[r] == 0:
                    done.append((r, eng.release(r)))
    for r in list(budget):
        if budget[r] > 0 and r in eng._streams:
            done.append((r, eng.release(r)))
    eng.release_prefix(pid)
    greedy = [(expected[r][1], s) for r, s in done if expected[r][0]]
    assert all(0 <= t < 97 for _, s in done for t in s)
    assert len(done) >= 6 and len(greedy) >= 3
    return dict(prompts=[p for p, _ in greedy],
                streams=[s for _, s in greedy])


def _records(recorder):
    """Every record with its clock readings dropped."""
    return [{k: v for k, v in r.items()
             if k != "ts" and not k.endswith("_ms")}
            for r in recorder.records]


def _obs_counts(obs):
    st = obs.status()
    return dict(
        steps=(st["steps"]["count"], st["steps"]["emitted_tokens"]),
        requests=sorted((r["id"], r["tokens"], r["cached_tokens"],
                         r["computed_tokens"], r["kv_blocks"])
                        for r in st["requests"]),
        finished=st["finished"],
    )


@pytest.fixture(scope="module")
def shared(models):
    """Both engines through one script. The greedy-only scenarios come
    first: after them the speculative counters, the flight records and the
    observatory are snapshot (sampled rows accept differently in the two
    frameworks, so later counters differ)."""
    runs = {}
    for side, tel, ro in (("jax", jtel, jro), ("port", ttel, tro)):
        rec = tel.FlightRecorder(path="", trace_id="")
        obs = ro.RequestObservatory()
        eng = _engine(side, models, prefix_cache=True, recorder=rec,
                      observatory=obs, **SHARED)
        out = dict(churn=_churn(eng), prefix=_prefix(eng),
                   reject=_reject_topk(eng))
        out["snapshot"] = dict(spec=eng.stats()["speculative"],
                               records=_records(rec), obs=_obs_counts(obs))
        out["mixed"] = _mixed(eng)
        out["soak"] = _soak(eng)
        # what the prefix cache holds once every request is released
        out["used_blocks"] = (eng.used_blocks,
                              eng.stats()["prefix_cache"]["cached_blocks"])
        runs[side] = out
    return runs


def _exact(models, run):
    for prompt, stream in zip(run["prompts"], run["streams"]):
        assert stream and stream == _oracle(models, prompt, len(stream)), (
            prompt)


def test_spec_greedy_streams_exact_with_churn(models, shared):
    want, got = shared["jax"]["churn"], shared["port"]["churn"]
    assert got == want
    for out in got["outs"]:
        assert all(isinstance(v, list) and len(v) >= 1 for v in out.values())
    _exact(models, got)


def test_spec_prefix_admissions_exact(models, shared):
    want, got = shared["jax"]["prefix"], shared["port"]["prefix"]
    assert got == want
    assert got["prefix_cache"]["hits"] >= 1
    _exact(models, got)


def test_spec_rejects_topk_topp(models, shared):
    assert shared["port"]["reject"] == shared["jax"]["reject"]
    _exact(models, shared["port"]["reject"])


def test_spec_stats_records_and_observatory_equal_jax(shared):
    """The speculative counters, every flight record (duration apart) and
    the observatory's counts equal JAX's. The observatory counts a spec
    step's committed tokens per step (emitted_tokens) but, as the JAX
    engine, calls no per-request tokens_emitted on spec steps: a record
    keeps tokens == 1 however many tokens its stream has (ROADMAP Queue 3,
    inherited)."""
    want, got = shared["jax"]["snapshot"], shared["port"]["snapshot"]
    assert got["spec"] == want["spec"]
    assert got["spec"]["rounds"] > 0 and set(got["spec"]) == {
        "rounds", "gamma", "drafted_tokens", "accepted_tokens",
        "rejected_tokens", "acceptance_rate"}
    assert got["records"] == want["records"]
    assert got["obs"] == want["obs"]
    assert all(tokens == 1 for _, tokens, *_ in got["obs"]["requests"])


def test_spec_mixed_greedy_and_sampled_rows(models, shared):
    assert shared["port"]["mixed"] == shared["jax"]["mixed"]
    _exact(models, shared["port"]["mixed"])


def test_spec_soak_random_schedule_greedy_exact(models, shared):
    assert shared["port"]["soak"] == shared["jax"]["soak"]
    _exact(models, shared["port"]["soak"])
    used, cached = shared["port"]["used_blocks"]
    assert used == cached and shared["jax"]["used_blocks"] == (used, cached)


# -- engines of their own ------------------------------------------------------


def _self_draft(eng):
    """Draft == target: each live row commits gamma + 1 tokens a step;
    then a stop token inside a round ends the stream at the stop."""
    pa, pb = [5, 17, 42], [61, 3]
    ra, rb = eng.admit(pa), eng.admit(pb)
    first = eng.step()
    full = [len(first[ra]), len(first[rb])]
    streams = [eng.release(ra), eng.release(rb)]
    prompt = [5, 17, 42, 9]
    ref_rid = eng.admit(prompt)
    while len(eng.stream(ref_rid)) < 12:
        eng.step()
    ref = eng.release(ref_rid)[:12]
    rid = eng.admit(prompt, stop_tokens=[ref[2]])
    steps = 0
    while rid in eng._slot_of and steps < 10:
        eng.step()
        steps += 1
    reason = eng.finish_reason[rid]
    return dict(full=full, streams=streams, ref=ref,
                stopped=eng.release(rid), reason=reason,
                spec=eng.stats()["speculative"])


def test_spec_draft_equals_target_and_stop_token(models):
    kw = dict(slots=2, max_len=64, prompt_buckets=(8,), gamma=4)
    want = _self_draft(_engine("jax", models, draft="target", **kw))
    got = _self_draft(_engine("port", models, draft="target", **kw))
    assert got == want
    assert got["full"] == [5, 5]
    assert got["spec"]["accepted_tokens"] == got["spec"]["drafted_tokens"]
    for prompt, stream in zip(([5, 17, 42], [61, 3]), got["streams"]):
        assert len(stream) == 6 and stream == _oracle(models, prompt, 6)
    ref = got["ref"]
    assert ref == _oracle(models, [5, 17, 42, 9], 12)
    assert got["reason"] == "stop_token"
    assert got["stopped"] == ref[: ref.index(ref[2]) + 1]


def _near_max_len(eng):
    prompt = [5, 17, 42, 9, 61, 3, 88, 24]
    rid = eng.admit(prompt)
    steps = 0
    while rid in eng._slot_of and steps < 20:
        eng.step()
        steps += 1
    return dict(reason=eng.finish_reason[rid], stream=eng.release(rid),
                spec=eng.stats()["speculative"])


def test_spec_near_max_len_falls_back_and_finishes(models, monkeypatch):
    """A row within gamma of max_len makes the step fall back to a draft
    catch-up and a plain step; the row finishes at the row end, exactly.
    The port runs the fallback on the gather path and on the paged
    kernel (its plain version here): one paged call a layer a fallback
    step, and no other spec-mode call."""
    kw = dict(slots=1, max_len=16, prompt_buckets=(8,), gamma=4)
    want = _near_max_len(_engine("jax", models, **kw))
    assert want["reason"] == "max_len" and len(want["stream"]) >= 7
    calls = []
    real = ts.paged_decode_attention
    monkeypatch.setattr(ts, "paged_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for paged in (False, True):
        calls.clear()
        eng = _engine("port", models, paged_kernel=paged, **kw)
        got = _near_max_len(eng)
        assert got == want, f"paged_kernel={paged}"
        fallback = eng.decode_steps_total
        assert fallback >= 1
        assert len(calls) == (BASE["n_layers"] * fallback if paged else 0)
    assert got["stream"] == _oracle(models, [5, 17, 42, 9, 61, 3, 88, 24],
                                    len(got["stream"]))


def _b_stream(eng, temp_b):
    """A sampled at 0.8 beside B at temp_b for 6 steps; A's stream."""
    ra = eng.admit([5, 17, 42, 9], temperature=0.8)
    rb = eng.admit([3, 88, 1], temperature=temp_b)
    for _ in range(6):
        eng.step()
    eng.release(rb)
    return eng.release(ra)


def test_spec_sampled_row_does_not_depend_on_neighbour(models):
    """The spec step draws its draft, accept and correction uniforms for
    every slot on every step, so A's sampled stream is the same beside a
    greedy or a sampled neighbour."""
    kw = dict(slots=2, max_len=64, prompt_buckets=(8,), gamma=3, seed=5)
    beside_greedy = _b_stream(_engine("port", models, **kw), 0.0)
    beside_sampled = _b_stream(_engine("port", models, **kw), 1.3)
    assert len(beside_greedy) >= 7 and beside_greedy == beside_sampled


def test_spec_constructor_validation(models):
    """JAX's checks, messages and order, on both engines."""
    jcfg, jdcfg, tree, dtree = models["jax"]
    tcfg, tdcfg, params, dparams = models["port"]
    moe = dict(BASE, moe_experts=2)
    jpool = js.SharedKVPool(jcfg, block_size=8, pool_blocks=16)
    tpool = ts.SharedKVPool(tcfg, block_size=8, pool_blocks=16, device="cpu")
    cases = [
        (dict(gamma=0), {}, "gamma"),
        (dict(top_k=50), {}, "engine-wide top-k"),
        (dict(role="prefill", prefix_cache=True), {}, "disaggregated"),
        (dict(pool="pool"), {}, "shared pool"),
        (dict(kv_int8=True), {}, "kv_int8"),
        ({}, dict(vocab=50), "vocabularies"),
        ({}, dict(moe_experts=2), "dense"),
    ]
    for kw, dkw, match in cases:
        for side, cfg, dcfg, p, dp, pool, make in (
            ("jax", jcfg, jdcfg, tree, dtree, jpool, js.ServingEngine),
            ("port", tcfg, tdcfg, params, dparams, tpool, ts.ServingEngine),
        ):
            kw2 = dict(kw, pool=pool) if "pool" in kw else dict(kw)
            if dkw:
                mod = jt if side == "jax" else tt
                dtype = jnp.float32 if side == "jax" else torch.float32
                dcfg = mod.ModelConfig(**{**DRAFT, **dkw}, dtype=dtype)
            if "moe_experts" in dkw:
                cfg = (jt if side == "jax" else tt).ModelConfig(
                    **moe, dtype=jnp.float32 if side == "jax"
                    else torch.float32)
            extra = {} if side == "jax" else dict(device="cpu")
            with pytest.raises(ValueError, match=match):
                make(p, cfg, draft_params=dp, draft_cfg=dcfg, **kw2, **extra)


def _learned_finish_beside_live(eng):
    """Self-draft on a learned-position model with max_seq == max_len: A
    commits full rounds up to the row end and finishes at max_len while
    B is still decoding; B's later rounds (and its fallback steps) run
    over A's freed slot, whose stale length sits at the row end."""
    ra = eng.admit([5, 17, 42, 9, 61, 3, 88, 24])
    rb = eng.admit([3, 88])
    steps = 0
    while rb in eng._slot_of and steps < 40:
        eng.step()
        steps += 1
    return dict(reasons=[eng.finish_reason[ra], eng.finish_reason[rb]],
                streams=[eng.release(ra), eng.release(rb)],
                spec=eng.stats()["speculative"])


def test_spec_learned_positions_row_finishes_beside_live_row():
    """A freed slot's stale length can reach max_len after a full round;
    the learned position table has only max_len rows. The row beside it
    decodes on, exactly as on the JAX engine and as greedy generate(), on
    the gather path and through the paged kernel's fallback steps."""
    learned = dict(BASE, pos="learned", max_seq=32)
    jcfg = jt.ModelConfig(**learned, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**learned, dtype=torch.float32)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(3)))
    params = params_from_jax(tree, tcfg, device="cpu")
    kw = dict(slots=2, max_len=32, prompt_buckets=(8,), gamma=3)
    want = _learned_finish_beside_live(js.ServingEngine(
        tree, jcfg, draft_params=tree, draft_cfg=jcfg, **kw))
    for paged in (False, True):
        got = _learned_finish_beside_live(ts.ServingEngine(
            params, tcfg, draft_params=params, draft_cfg=tcfg, device="cpu",
            paged_kernel=paged, **kw))
        assert got == want, f"paged_kernel={paged}"
    assert got["reasons"] == ["max_len", "max_len"]
    # generate() holds prompt + new tokens within max_seq: the oracle
    # covers each stream up to the table's end
    for prompt, stream in zip(([5, 17, 42, 9, 61, 3, 88, 24], [3, 88]),
                              got["streams"]):
        n = min(len(stream), 32 - len(prompt))
        oracle = tg.generate(params, [prompt], tcfg, n,
                             device="cpu")[0, len(prompt):].tolist()
        assert n >= 20 and stream[:n] == oracle

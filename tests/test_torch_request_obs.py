"""The port's request observatory (elastic_tpu_agent_torch/workloads/
request_obs.py, ServingEngine(observatory=)) against the JAX package:
the same event script under a ManualClock gives the same status() and
records; bind_metrics observes the same histograms through the port's
AgentMetrics (the agent's families); and real engines on both sides, driven by one script of
calls (admit/step/release churn, a cancelled prefill, a drain, a
disaggregated pair sharing one observatory, a mid-stream handoff), keep
equal ledgers with conservation and one partition per stitched id."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent import common as jcommon  # noqa: E402
from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import request_obs as jro  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import telemetry as jtel  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch import common as tcommon  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle as tlc  # noqa: E402
from elastic_tpu_agent_torch.workloads import request_obs as tro  # noqa: E402
from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=192, pos="rope")
PROMPT = [((7 * i) % 89) + 2 for i in range(40)]
SIDES = {"jax": (jro, jcommon), "port": (tro, tcommon)}


def test_module_constants_and_clock_match_jax():
    for name in ("PHASES", "SLO_CLASSES", "DEFAULT_SLO",
                 "DEFAULT_SLO_TARGETS", "DEFAULT_MAX_FINISHED",
                 "DEFAULT_MAX_PENDING_HANDOFF", "DEFAULT_STEP_WINDOW",
                 "DEFAULT_SAMPLE_WINDOW"):
        assert getattr(tro, name) == getattr(jro, name), name
    for junk in (None, "ttft", "junk", ""):
        assert tro.normalize_slo(junk) == jro.normalize_slo(junk)
    a, b = tcommon.ManualClock(), jcommon.ManualClock()
    a.advance(2.5), b.advance(2.5)
    assert (a.time(), a.monotonic()) == (b.time(), b.monotonic())
    assert abs(tcommon.SYSTEM_CLOCK.time() - jcommon.SYSTEM_CLOCK.time()) < 5


# -- event scripts under a ManualClock ---------------------------------------


def _partition(obs, clock):
    uid = obs.admit("eng", slo="ttft")
    clock.advance(0.5)
    obs.prefill_start(uid)
    clock.advance(2.0)
    obs.first_token(uid)
    clock.advance(1.0)
    obs.stall_begin("eng")
    clock.advance(4.0)
    obs.stall_end("eng")
    clock.advance(1.5)
    obs.tokens_emitted(uid, 9)
    return [obs.finish(uid, "released")]


def _stalls(obs, clock):
    decoding = obs.admit("A")
    obs.prefill_start(decoding)
    obs.first_token(decoding)
    prefilling = obs.admit("A")
    obs.prefill_start(prefilling)
    elsewhere = obs.admit("B", slo="tpot")
    obs.prefill_start(elsewhere)
    obs.first_token(elsewhere)
    obs.stall_begin("A")
    obs.stall_begin("A")              # nested: the inner end must not resume
    clock.advance(3.0)
    obs.stall_end("A")
    clock.advance(1.0)
    obs.stall_end("A")
    clock.advance(1.0)
    return [obs.finish(u) for u in (decoding, prefilling, elsewhere)]


def _stitched(obs, clock, dec_obs):
    uid = obs.admit("pre", slo="ttft")
    obs.prefill_start(uid)
    clock.advance(2.0)
    obs.prefill_done(uid, computed_tokens=40, chain_digests=(b"d0", b"d1"),
                     prefix_digest="ab", kv_blocks=5, kv_bytes=640)
    rec = obs.handoff_begin(uid)
    clock.advance(0.25)
    dec_obs.adopt(rec, engine_key="dec")
    clock.advance(0.75)
    dec_obs.first_token(rec.uid)
    clock.advance(1.0)
    dec_obs.tokens_emitted(rec.uid, 4)
    return [dec_obs.finish(rec.uid, "released")]


def _junk(obs, clock):
    for i in range(1500):
        uid = obs.admit("eng", slo=f"junk-{i}" if i % 3 else "tpot")
        obs.prefill_start(uid)
        clock.advance(0.001 * (i % 7))
        obs.first_token(uid)
        clock.advance(0.0005)
        obs.tokens_emitted(uid, 1 + i % 4)
        obs.finish(uid, ("released", "max_len")[i % 2])
        obs.step("eng", live=1, slots=4, emitted_tokens=1, activated=i % 2,
                 prefill_s=0.001, decode_s=0.002)
    return []


def _expiry(obs, clock):
    for i in range(50):
        uid = obs.admit("pre")
        obs.prefill_start(uid)
        obs.prefill_done(uid, chain_digests=(bytes([i]),))
        obs.handoff_begin(uid)
        clock.advance(0.1)
    return []


SCRIPTS = {"partition": _partition, "stalls": _stalls,
           "stitched": _stitched, "junk": _junk, "expiry": _expiry}


class _Hist:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def labels(self, **kw):
        return _Obs(self.log, self.name, kw)


class _Obs:
    def __init__(self, log, name, labels):
        self.log, self.name, self.labels = log, name, labels

    def observe(self, v):
        self.log.append((self.name, tuple(sorted(self.labels.items())), v))


class _Metrics:
    """Any object with the agent's three request histograms."""

    def __init__(self):
        self.log = []
        for name in ("request_ttft", "request_tpot", "request_phase_seconds"):
            setattr(self, name, _Hist(self.log, name))


def _replay(side, name):
    ro, common = SIDES[side]
    clock = common.ManualClock()
    metrics = _Metrics()
    rec = (jtel if side == "jax" else ttel).FlightRecorder(
        path="", trace_id="obs-trace")
    kw = dict(clock=clock, recorder=rec, max_pending_handoff=8)
    obs = ro.RequestObservatory(**kw)
    obs.bind_metrics(metrics)
    if name == "stitched":
        dec = ro.RequestObservatory(**kw)
        dec.bind_metrics(metrics)
        done = SCRIPTS[name](obs, clock, dec)
        statuses = (obs.status(), dec.status())
    else:
        done = SCRIPTS[name](obs, clock)
        statuses = (obs.status(), obs.status(slo="tpot", limit=3),
                    obs.status(request_id=0))
    records = [{k: v for k, v in r.items() if k != "ts"}
               for r in rec.records]
    return ([d.to_dict() for d in done], statuses, metrics.log, records,
            {k: v for k, v in rec.summary().items()
             if k.startswith("request")})


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_status_after_event_script_matches_jax(name):
    """status(), each finished record, the request_finish flight records
    and their summary, and every histogram observation through
    bind_metrics: equal to the JAX observatory's."""
    assert _replay("port", name) == _replay("jax", name)


def test_event_script_readings():
    done, statuses, log, records, summary = _replay("port", "partition")
    assert done[0]["phases_ms"] == {"queued": 500.0, "prefill": 2000.0,
                                    "decode": 2500.0, "stalled": 4000.0}
    assert done[0]["residual_ms"] == 0.0 and done[0]["ttft_ms"] == 2500.0
    assert statuses[0]["conservation"]["worst_residual_ms"] == 0.0
    assert [r["kind"] for r in records] == ["request_finish"]
    assert summary["request_slo"]["ttft"]["ttft_p50_ms"] == 2500.0
    assert ("request_ttft", (("slo", "ttft"),), 2.5) in log
    done, statuses, *_ = _replay("port", "stitched")
    assert done[0]["stitched"] and done[0]["phases_ms"]["handoff"] == 250.0
    assert statuses[0]["finished"] == 0 and statuses[1]["stitched"] == 1
    _, statuses, *_ = _replay("port", "expiry")
    assert statuses[0]["finish_reasons"] == {"handoff_expired": 42}
    assert statuses[0]["pending_handoff"] == 8
    _, statuses, *_ = _replay("port", "junk")
    assert statuses[0]["slo_coerced"] == 1000
    assert set(statuses[0]["classes"]) <= set(tro.SLO_CLASSES)


def test_agent_metrics_bind_the_port_observatory():
    """The port's AgentMetrics.attach_requests (its /debug/requests and
    request histograms, the agent's families) binds the port's
    observatory."""
    from prometheus_client import CollectorRegistry, generate_latest

    from elastic_tpu_agent_torch.metrics import AgentMetrics

    registry = CollectorRegistry()
    m = AgentMetrics(registry=registry)
    clock = tcommon.ManualClock()
    obs = tro.RequestObservatory(clock=clock)
    m.attach_requests(obs)
    for slo in ("ttft", "tpot", "nonsense"):
        uid = obs.admit("eng", slo=slo)
        obs.prefill_start(uid)
        clock.advance(0.1)
        obs.first_token(uid)
        clock.advance(0.02)
        obs.tokens_emitted(uid, 3)
        obs.finish(uid)
    text = generate_latest(registry).decode()
    assert 'elastic_tpu_request_ttft_seconds_count{slo="ttft"} 1.0' in text
    assert 'elastic_tpu_request_ttft_seconds_count{slo="batch"} 1.0' in text
    assert obs.slo_coerced == 1


# -- real engines ------------------------------------------------------------


def _models():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _strip_engines(status):
    """Step records name each engine by its id(); the rest must agree."""
    st = dict(status)
    st["steps"] = dict(st["steps"], recent=[
        {k: v for k, v in r.items() if k != "engine"}
        for r in st["steps"]["recent"]])
    return st


def _engine_script(S, lc, ro, common, tel, params, cfg, dev):
    """Churn on a unified engine (release, a cancelled chunked prefill, a
    stop at max_len, a drain), then a disaggregated pair sharing one
    observatory, then a mid-stream handoff on the pair; the clock advances
    between calls."""
    clock = common.ManualClock()
    rec = tel.FlightRecorder(path="", trace_id="")
    obs = ro.RequestObservatory(clock=clock, recorder=rec)
    eng = S.ServingEngine(params, cfg, slots=2, max_len=64,
                          prompt_buckets=(8, 64), observatory=obs,
                          recorder=rec, **dev)
    released = eng.admit(PROMPT, slo="ttft")
    clock.advance(0.5)
    eng.step()
    clock.advance(0.25)
    eng.release(released)
    cancelled = eng.enqueue(PROMPT, slo="tpot")
    clock.advance(0.125)
    eng.step()
    eng.release(cancelled)
    eng.admit(PROMPT[:8])
    clock.advance(0.5)
    eng.enqueue(PROMPT[:8], slo="bogus")
    clock.advance(0.5)
    eng.step()
    clock.advance(1.0)
    summary = lc.drain_serving(eng)
    out = {"churn": (_strip_engines(obs.status()), summary)}
    admits = [r for r in rec.records if r["kind"] == "serving_admit"]
    finishes = [r for r in rec.records if r["kind"] == "request_finish"]
    out["join"] = ([r["request_uid"] for r in admits],
                   [r["request_id"] for r in finishes],
                   [{k: v for k, v in r.items() if k != "ts"}
                    for r in finishes])

    pool = S.SharedKVPool(cfg, block_size=8, pool_blocks=64, **dev)
    obs2 = ro.RequestObservatory(clock=clock)
    kw = dict(max_len=128, prompt_buckets=(8, 64), pool=pool,
              observatory=obs2, **dev)
    pre = S.ServingEngine(params, cfg, slots=1, role="prefill", **kw)
    dec = S.ServingEngine(params, cfg, slots=2, role="decode", **kw)
    peer = S.ServingEngine(params, cfg, slots=2, role="decode", **kw)
    rp = pre.admit(PROMPT, slo="ttft")
    pre.release(rp)
    out["pending"] = obs2.pending_handoff_count
    clock.advance(0.5)
    rd = dec.admit(PROMPT)
    for _ in range(3):
        clock.advance(0.01)
        dec.step()
    rq = pre.enqueue([((3 * i) % 89) + 2 for i in range(20)], slo="tpot")
    while pre._pending:
        clock.advance(0.05)
        pre.step()
    clock.advance(0.2)
    rd2 = dec.admit([((3 * i) % 89) + 2 for i in range(20)])
    clock.advance(0.1)
    dec.step()
    dec.publish_stream(rd)
    clock.advance(0.3)
    ra = peer.adopt_stream()
    for _ in range(3):
        clock.advance(0.01)
        peer.step()
        dec.step()
    peer.release(ra)
    dec.release(rd2)
    pre.release(rq)
    out["pair"] = _strip_engines(obs2.status())
    return out


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg, tree, params = _models()
    return {
        "jax": _engine_script(js, jlc, jro, jcommon, jtel, tree, jcfg, {}),
        "port": _engine_script(ts, tlc, tro, tcommon, ttel, params, tcfg,
                               dict(device="cpu")),
    }


@pytest.mark.parametrize("key", ["churn", "join", "pending", "pair"])
def test_engine_ledgers_match_jax(engines, key):
    assert engines["port"][key] == engines["jax"][key]


def test_churn_and_drain_conserve(engines):
    st, summary = engines["port"]["churn"]
    assert summary["live_requests"] == 0
    assert st["live"] == 0 and st["finished"] == 4
    assert st["finish_reasons"].get("cancelled") == 1
    assert st["slo_coerced"] == 1
    assert st["conservation"]["worst_residual_ms"] == 0.0
    for rec in st["requests"]:
        total = sum(rec["phases_ms"].values()) + rec["residual_ms"]
        assert total == pytest.approx(rec["wall_ms"], abs=1e-3)
    uids, ids, _ = engines["port"]["join"]
    assert uids and set(uids) <= set(ids)


def test_stitching_one_partition_per_id(engines):
    st = engines["port"]["pair"]
    assert engines["port"]["pending"] == 1
    assert st["stitched"] == 3 and st["pending_handoff"] == 0
    ids = [r["id"] for r in st["requests"]]
    assert len(ids) == len(set(ids)) == 2
    first = next(r for r in st["requests"] if r["slo"] == "ttft")
    for phase in ("prefill", "handoff", "decode"):
        assert phase in first["phases_ms"], first["phases_ms"]
    assert first["cached_tokens"] >= len(PROMPT) - 8
    assert st["handoffs_published"] == st["handoffs_adopted"] == 3


def test_real_clock_conservation_within_a_millisecond():
    _, tcfg, _, params = _models()
    obs = tro.RequestObservatory()
    eng = ts.ServingEngine(params, tcfg, slots=2, max_len=64,
                           prompt_buckets=(8, 64), observatory=obs,
                           device="cpu")
    r = eng.admit(PROMPT, slo="ttft")
    eng.enqueue(PROMPT[:9], slo="tpot")
    for _ in range(4):
        eng.step()
    eng.release(r)
    tlc.drain_serving(eng)
    st = obs.status()
    assert st["finished"] == 2 and st["live"] == 0
    assert abs(st["conservation"]["worst_residual_ms"]) < 1.0
    for rec in st["requests"]:
        total = sum(rec["phases_ms"].values()) + rec["residual_ms"]
        assert abs(total - rec["wall_ms"]) < 1.0

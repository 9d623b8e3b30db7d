"""The port's SharedKVPool, prefill/decode roles and mid-stream handoff
(elastic_tpu_agent_torch/workloads/serving.py, lifecycle.drain_serving(
handoff=True)) against the JAX package: one script of calls drives a
prefill-role engine and two decode-role engines over one pool on each
side, and the greedy streams, prefill counters, stats(),
disaggregated_status(), the pool's registries, drain summaries and acks
must be equal; the handed-off streams must also equal the port's
uninterrupted ones. float32 weights."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import request_obs as jro  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle as tlc  # noqa: E402
from elastic_tpu_agent_torch.workloads import request_obs as tro  # noqa: E402
from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
    random_tree,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=192, pos="rope")
ENGINE = dict(max_len=128, prompt_buckets=(8, 64))
PROMPT = [((7 * i) % 89) + 2 for i in range(40)]
PROMPT2 = [((3 * i) % 89) + 2 for i in range(40)]
BURST = [((5 * i) % 89) + 2 for i in range(56)]


def _models():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _engines(S, params, cfg, dev):
    """A pool with a prefill-role engine (1 slot) and two decode-role
    engines (2 slots each)."""
    pool = S.SharedKVPool(cfg, block_size=8, pool_blocks=64, **dev)
    kw = dict(ENGINE, pool=pool, **dev)
    return (pool,
            S.ServingEngine(params, cfg, slots=1, role="prefill", **kw),
            S.ServingEngine(params, cfg, slots=2, role="decode", **kw),
            S.ServingEngine(params, cfg, slots=2, role="decode", **kw))


def _script(S, lc, params, cfg, dev, alloc):
    """Publish-and-adopt through admit and enqueue, the head-of-line
    interleave, a mid-stream and a chained handoff, an adoption refused
    for want of a slot, registry overflow, and a handoff drain. Returns
    {name: observation}."""
    pool, pre, dec, dst = _engines(S, params, cfg, dev)
    o = {}
    rp = pre.admit(PROMPT)
    o["pre_reason"] = pre.finish_reason[rp]
    o["first"] = pre.release(rp)
    o["held_after_prefill"] = (pool.used_blocks,
                               pool.prefix_cache.cached_blocks)
    rd = dec.admit(PROMPT)
    o["adopt"] = (dec.prefilled_tokens_total, pool.adoptions,
                  pool.adopted_tokens, dec.adopted_tokens_total)
    o["status_one"] = S.disaggregated_status(pre, dec)
    for _ in range(6):
        dec.step()
    o["stream"] = dec.release(rd)
    # the prefill role through enqueue: one chunk a step
    rq = pre.enqueue(PROMPT2)
    ticks = 0
    while pre._pending:
        pre.step()
        ticks += 1
    o["chunked"] = (ticks, pre.finish_reason[rq], pre.release(rq))
    before = dec.prefilled_tokens_total
    rd2 = dec.admit(PROMPT2)
    o["chunked_tail"] = dec.prefilled_tokens_total - before
    dec.release(rd2)
    # head-of-line: the decode stream advances every tick of a burst
    r_live = dec.admit([9, 8, 7])
    dec.step()
    n0 = len(dec.stream(r_live))
    pre.enqueue(BURST)
    ticks = 0
    while pre._pending:
        pre.step()
        dec.step()
        ticks += 1
    o["burst"] = (ticks, len(dec.stream(r_live)) - n0)
    dec.release(r_live)
    o["stats"] = (pre.stats(), dec.stats())
    o["status"] = S.disaggregated_status(pre, dec)
    # mid-stream handoff dec -> dst, then chained back dst -> dec
    rs = dec.admit(PROMPT)
    for _ in range(7):
        dec.step()
    rec = dec.publish_stream(rs)
    o["record"] = (rec["kind"], rec["host_len"], rec["stream"], rec["last"],
                   [d.hex() for d in rec["digests"]], len(rec["blocks"]),
                   pool.pending_streams, dec.stats()["live_requests"])
    ra = dst.adopt_stream()
    for _ in range(9):
        dst.step()
    dst.publish_stream(ra)
    rb = dec.adopt_stream()
    for _ in range(8):
        dec.step()
    o["chained"] = dec.release(rb)
    # adoption without a free slot restores the record at the front
    rs = dec.admit(PROMPT2)
    for _ in range(5):
        dec.step()
    dec.publish_stream(rs)
    blockers = [dst.admit([3, 5, 7]), dst.admit([4, 6])]
    with pytest.raises(ValueError, match="free slot") as e:
        dst.adopt_stream()
    o["refused"] = (str(e.value), pool.pending_streams, pool.adopted_streams)
    dst.release(blockers[0])
    rc = dst.adopt_stream()
    for _ in range(4):
        dst.step()
    o["restored"] = dst.release(rc)
    dst.release(blockers[1])
    # registry overflow expires the oldest record and frees its blocks
    pool.max_pending_streams = 1
    r1 = dec.admit(PROMPT)
    r2 = dec.admit([11, 13, 17, 19] * 6)
    for _ in range(4):
        dec.step()
    dec.publish_stream(r1)
    used_one = pool.used_blocks
    dec.publish_stream(r2)
    o["overflow"] = (pool.pending_streams, pool.expired_streams,
                     used_one, pool.used_blocks)
    o["survivor"] = dst.release(dst.adopt_stream())
    o["drained_registry"] = dst.adopt_stream()
    pool.max_pending_streams = 256
    # the live-migration drain: pending prefills pumped, streams published
    ra = dec.admit(PROMPT)
    rb = dec.enqueue([23, 29, 31, 37] * 4)
    for _ in range(3):
        dec.step()
    watcher = lc.LifecycleWatcher(alloc, "h")
    o["drain"] = lc.drain_serving(dec, watcher, lc.Signal("drain", "op"),
                                  handoff=True)
    ack = lc.read_checkpoint_ack(alloc, "h")
    o["ack"] = {k: v for k, v in ack.items() if k != "ts"}
    got = []
    while True:
        rid = dst.adopt_stream()
        if rid is None:
            break
        got.append(rid)
    for _ in range(6):
        dst.step()
    o["drained_streams"] = [dst.release(r) for r in got]
    o["pool"] = pool.stats()
    o["engines"] = (pre.stats(), dec.stats(), dst.stats())
    o["leak"] = (pool.used_blocks, pool.prefix_cache.cached_blocks,
                 pool.prefix_cache.clear(), pool.used_blocks)
    return o


def _uninterrupted(S, params, cfg, dev, prompt, steps):
    eng = S.ServingEngine(params, cfg, slots=2, **ENGINE, **dev)
    rid = eng.admit(prompt)
    for _ in range(steps):
        eng.step()
    return eng.release(rid)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg, tree, params = _models()
    return {
        "jax": _script(js, jlc, tree, jcfg, {},
                       str(tmp_path_factory.mktemp("j"))),
        "port": _script(ts, tlc, params, tcfg, dict(device="cpu"),
                        str(tmp_path_factory.mktemp("t"))),
        "solo": [_uninterrupted(ts, params, tcfg, dict(device="cpu"), p, n)
                 for p, n in ((PROMPT, 6), (PROMPT, 24), (PROMPT2, 9))],
    }


KEYS = ["pre_reason", "first", "held_after_prefill", "adopt", "status_one",
        "stream", "chunked", "chunked_tail", "burst", "stats", "status",
        "record", "chained", "refused", "restored", "overflow", "survivor",
        "drained_registry", "drain", "ack", "drained_streams", "pool",
        "engines", "leak"]


@pytest.mark.parametrize("key", KEYS)
def test_script_matches_jax(runs, key):
    """Every observation of the script, key for key and value for value
    (ack paths name each side's own alloc directory)."""
    got, want = runs["port"][key], runs["jax"][key]
    if key == "ack":
        got, want = (dict(x, checkpoint_dir="") for x in (got, want))
    assert got == want


def test_disaggregated_stream_equals_unified(runs):
    o, solo = runs["port"], runs["solo"]
    assert o["first"] == solo[0][:1] and o["pre_reason"] == "prefilled"
    assert o["stream"] == solo[0]


def test_decode_adopts_blocks_prefills_only_the_tail(runs):
    o = runs["port"]
    # 40 tokens, block 8: blocks 0..3 adopted (32 tokens), 8-token tail
    assert o["adopt"] == (8, 1, 32, 32)
    assert o["held_after_prefill"][0] == o["held_after_prefill"][1] >= 4
    assert o["chunked"][:2] == (5, "prefilled") and o["chunked_tail"] == 8


def test_decode_advances_every_tick_of_a_prefill_burst(runs):
    assert runs["port"]["burst"] == (7, 7)


def test_status_shapes(runs):
    st = runs["port"]["status_one"]
    assert st["roles"]["prefill"]["queue_depth"] == 0
    assert st["roles"]["decode"]["queue_depth"] == 1
    assert st["shared_pool"]["adoptions"] == 1
    assert st["prefilled_tokens_total"] == len(PROMPT) + 8
    pre, dec = runs["port"]["stats"]
    assert (pre["role"], dec["role"]) == ("prefill", "decode")
    assert dec["shared_pool"]["adopted_tokens"] == dec[
        "adopted_tokens_total"]


def test_handed_off_streams_equal_uninterrupted(runs):
    o, solo = runs["port"], runs["solo"]
    assert o["chained"] == solo[1]           # dec -> dst -> dec, 24 steps
    assert o["restored"] == solo[2]          # refused once, then adopted
    assert o["refused"][1:] == (1, 2)        # restored, un-counted
    assert o["record"][0] == "stream" and o["record"][6:] == (1, 0)


def test_registry_overflow_and_drain(runs):
    o = runs["port"]
    pending, expired, used_one, used_after = o["overflow"]
    assert (pending, expired) == (1, 1) and used_after < used_one + 4
    assert o["survivor"] and o["drained_registry"] is None
    assert o["drain"]["handoff_streams"] == 2
    assert o["ack"]["kind"] == "drained" and o["ack"]["handoff_streams"] == 2
    assert all(len(s) > 0 for s in o["drained_streams"])
    ps = o["pool"]
    assert ps["published_streams"] == ps["adopted_streams"] + ps[
        "expired_streams"] and ps["pending_streams"] == 0
    used, cached, _, after = o["leak"]
    assert used == cached and after == 0


def test_shared_pool_and_role_rejections():
    _, tcfg, _, params = _models()
    pool = ts.SharedKVPool(tcfg, block_size=8, pool_blocks=64, device="cpu")
    kw = dict(device="cpu")
    cases = [
        (dict(role="verifier"), "role"),
        (dict(role="prefill"), "prefix cache"),
        (dict(prompt_buckets=(16,), block_size=16, pool=pool), "block_size"),
        (dict(kv_int8=True, pool=pool), "kv_int8"),
        (dict(paged_kernel=True, pool=pool), "paged_kernel"),
        (dict(pool=pool, pool_blocks=65), "pool_blocks"),
    ]
    for opt, match in cases:
        with pytest.raises(ValueError, match=match):
            ts.ServingEngine(params, tcfg, **kw, **opt)
    other = tt.ModelConfig(**dict(BASE, n_layers=3), dtype=torch.float32)
    with pytest.raises(ValueError, match="shared pool"):
        ts.ServingEngine(params_from_jax(random_tree(other, 1), other,
                                         device="cpu"),
                         other, pool=pool, **kw)
    meta = ts.SharedKVPool(tcfg, block_size=8, pool_blocks=4, device="meta")
    with pytest.raises(ValueError, match="lives on"):
        ts.ServingEngine(params, tcfg, pool=meta, **kw)
    eng = ts.ServingEngine(params, tcfg, pool=pool, **kw)
    assert eng.paged_kernel is False          # auto: the gather path
    solo = ts.ServingEngine(params, tcfg, **kw)
    with pytest.raises(ValueError, match="SharedKVPool"):
        solo.publish_stream(0)
    with pytest.raises(ValueError, match="SharedKVPool"):
        solo.adopt_stream()
    rid = eng.enqueue(PROMPT)
    with pytest.raises(ValueError, match="still prefilling"):
        eng.publish_stream(rid)
    with pytest.raises(ValueError, match="not live"):
        eng.publish_stream(rid + 1)



SYSTEM = PROMPT[:32]                   # four full blocks at block size 8
TAILS = {"A": [5, 6, 7], "B": [9, 10]}  # each shorter than a block


def _stitch_two(S, ro, params, cfg, dev, order):
    """Two prefill-role admissions, A (slo ttft) then B (slo tpot), share
    a system prompt and have tails shorter than a block, so their chains
    end at the same digest. The decode role then admits their prompts in
    ``order``. Returns, per decode admission in that order, the (slo,
    stitched, cached_tokens) of the partition it finished under, then the
    ledgers' counts."""
    pool = S.SharedKVPool(cfg, block_size=8, pool_blocks=64, **dev)
    obs = ro.RequestObservatory()
    kw = dict(ENGINE, pool=pool, observatory=obs, **dev)
    pre = S.ServingEngine(params, cfg, slots=2, role="prefill", **kw)
    dec = S.ServingEngine(params, cfg, slots=2, role="decode", **kw)
    for name, slo in (("A", "ttft"), ("B", "tpot")):
        pre.release(pre.admit(SYSTEM + TAILS[name], slo=slo))
    uids = []
    for name in order:
        rid = dec.admit(SYSTEM + TAILS[name])
        uids.append(dec._obs_uid[rid])
        dec.release(rid)
    st = obs.status()
    by_id = {r["id"]: (r["slo"], r["stitched"], r["cached_tokens"])
             for r in st["requests"]}
    return [by_id[u] for u in uids], (
        st["pending_handoff"], st["stitched"], pool.published_requests,
        pool.adopted_requests)


@pytest.mark.parametrize("order", ["AB", "BA"])
def test_shared_system_prompt_stitching_matches_jax(order):
    """JAX's stitching rule, pinned on both packages (ROADMAP Queue 3
    records it as a fault inherited from the reference): any cache-hit
    admission over a shared pool adopts the record published under its
    covered chain's last digest. So B's prefill continues A's pending
    partition (B's slo is lost) and republishes it, the first decode
    admission takes that merged record whatever its prompt, and the
    other opens a new, unstitched partition."""
    jcfg, tcfg, tree, params = _models()
    got = _stitch_two(ts, tro, params, tcfg, dict(device="cpu"), order)
    assert got == _stitch_two(js, jro, tree, jcfg, {}, order)
    (first, second), counts = got
    assert first == ("ttft", True, 64)      # A's partition, B's prefill in it
    assert second == ("batch", False, 32)   # unstitched
    assert counts == (0, 2, 2, 2)

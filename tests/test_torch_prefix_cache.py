"""The port's prefix cache (elastic_tpu_agent_torch/workloads/
prefix_cache.py and ServingEngine(prefix_cache=True), register_prefix,
admit/enqueue(prefix=)) against the JAX package: chain digests byte for
byte, the cache's lookup/insert/evict/cap decisions over scripted
operations, and engines driven by one script of calls on both sides,
whose greedy streams, prefill counters, stats() and flight records must
be equal, on the port's gather path and on its kernel path (the paged
kernel's plain version on the CPU). float32 weights."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import prefix_cache as jpc  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import telemetry as jtel  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    prefix_cache as tpc,
)
from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)
ENGINE = dict(slots=2, max_len=64, prompt_buckets=(4, 16), block_size=4)
SYSTEM = [7, 7, 30, 2, 51, 11, 29, 4, 9, 13, 21, 3]  # 12 = 3 blocks of 4
PATHS = ["gather", "paged"]


def _models():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference",
                          pos="rope")
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, pos="rope")
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


# -- digests and the cache's decisions (no model) ----------------------------


@pytest.mark.parametrize("tokens,bs", [
    (SYSTEM, 4),
    (list(range(10)), 3),               # a partial last block: no key
    (np.arange(40, dtype=np.int64) * 811, 8),   # int64 in, int32 hashed
    ([], 4),
])
def test_chain_hashes_byte_equal(tokens, bs):
    want = jpc.chain_hashes(tokens, bs)
    assert tpc.chain_hashes(tokens, bs) == want
    assert tpc.chain_hashes(torch.as_tensor(np.asarray(tokens)), bs) == want
    assert len(want) == len(tokens) // bs and all(len(d) == 16 for d in want)


def test_chain_hash_depends_on_history():
    a = tpc.chain_hashes([1, 2, 3, 4], 2)
    b = tpc.chain_hashes([9, 9, 3, 4], 2)
    assert a[1] != b[1] and a[0] != b[0]


# Each op: (name, args). Blocks are named by their allocation order so
# that the two allocators' ids need not agree for the script to apply.
SCRIPTS = {
    "lookup_partial_miss": [
        ("alloc", 3), ("insert", list(range(10, 22)), [0, 1, 2]),
        ("lookup", list(range(10, 22))),
        ("lookup", list(range(10, 14)) + [99, 98, 97, 96]),
        ("lookup", [77] * 8),
        ("record", 12), ("record", 4), ("record", 0),
    ],
    "dedup": [
        ("alloc", 4), ("insert", list(range(8)), [0, 1]),
        ("insert", list(range(8)), [2, 3]),
        ("insert", list(range(12)), [2, 3, 0]),
        ("lookup", list(range(12))),
    ],
    "shared_eviction": [
        ("alloc", 3), ("insert", list(range(12)), [0, 1, 2]),
        ("drop", 0), ("drop", 1), ("drop", 2), ("share", 1),
        ("reclaim", 10), ("lookup", list(range(12))), ("drop", 1),
        ("clear",), ("lookup", list(range(12))),
    ],
    "cap": [
        ("alloc", 5), ("insert", list(range(16)), [0, 1, 2, 3]),
        ("drop", 0), ("drop", 1), ("drop", 2), ("drop", 3),
        ("insert", list(range(100, 104)), [4]),
        ("lookup", list(range(100, 104))), ("lookup", list(range(16))),
    ],
    "pressure": [
        ("alloc", 6), ("insert", list(range(24)), [0, 1, 2, 3, 4, 5]),
        ("drop", 0), ("drop", 1), ("drop", 2), ("drop", 4),
        ("lookup", list(range(8))),           # refreshes blocks 0, 1
        ("alloc", 2), ("alloc", 1),           # a dry free list reclaims
        ("lookup", list(range(24))),
    ],
}


def _run_script(mod_alloc, mod_cache, script, n_blocks, cap):
    """One (op, result, (used, cached, refcounts)) entry per op."""
    alloc = mod_alloc(n_blocks)
    cache = mod_cache(alloc, block_size=4, max_blocks=cap)
    alloc.reclaim = cache.reclaim
    named, trace = [], []
    for op, *args in script:
        res = None
        if op == "alloc":
            try:
                named += [alloc.alloc() for _ in range(args[0])]
            except RuntimeError as e:
                res = str(e)
        elif op == "insert":
            res = cache.insert(args[0], [named[j] for j in args[1]])
        elif op == "lookup":
            blocks, covered = cache.lookup(args[0])
            res = ([named.index(b) for b in blocks], covered)
        elif op == "record":
            cache.record_admission(args[0])
        elif op == "drop":
            alloc.drop(named[args[0]])
        elif op == "share":
            alloc.share(named[args[0]])
        elif op == "reclaim":
            res = cache.reclaim(args[0])
        elif op == "clear":
            res = cache.clear()
        trace.append((op, res, (alloc.used, cache.cached_blocks,
                                [int(alloc._ref[b]) for b in named])))
    return trace, cache.stats()


@pytest.mark.parametrize("cap", [None, 2, 5])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cache_decisions_match_jax(name, cap):
    """Lookup, insert, LRU eviction and cap decisions over a scripted op
    sequence: the same trace (results, occupancy, refcounts) and stats."""
    n_blocks = 8 if name == "pressure" else 16
    want = _run_script(js.BlockAllocator, jpc.PrefixCache, SCRIPTS[name],
                       n_blocks, cap)
    got = _run_script(ts.BlockAllocator, tpc.PrefixCache, SCRIPTS[name],
                      n_blocks, cap)
    assert got == want


def test_cache_decisions_pin_known_values():
    """The scripts' readings that the JAX tests pin, on the port."""
    trace, st = _run_script(ts.BlockAllocator, tpc.PrefixCache,
                            SCRIPTS["lookup_partial_miss"], 16, None)
    assert [t[1] for t in trace[2:5]] == [([0, 1, 2], 12), ([0], 4), ([], 0)]
    assert (st["hits"], st["misses"], st["hit_tokens"]) == (2, 1, 16)
    trace, st = _run_script(ts.BlockAllocator, tpc.PrefixCache,
                            SCRIPTS["shared_eviction"], 16, None)
    # the block a table still maps survives the sweep; its evicted parent
    # makes the chain walk miss at block 0
    assert trace[6][1] == 2 and trace[6][2][2] == [0, 2, 0]
    assert trace[7][1] == ([], 0) and st["evictions"] == 3
    trace, st = _run_script(ts.BlockAllocator, tpc.PrefixCache,
                            SCRIPTS["cap"], 32, 2)
    assert st["cached_blocks"] == 2 and st["evictions"] == 3
    trace, st = _run_script(ts.BlockAllocator, tpc.PrefixCache,
                            SCRIPTS["dedup"], 16, None)
    assert [t[1] for t in trace[1:4]] == [2, 0, 1]


def test_allocator_reclaim_hook():
    """alloc() asks the reclaim hook for a block before it declares the
    pool exhausted, as the JAX allocator does."""
    for mod in (js, ts):
        alloc = mod.BlockAllocator(3)
        calls = []

        def reclaim(n, alloc=alloc, calls=calls):
            calls.append(n)
            alloc.drop(held.pop())
            return 1

        held = [alloc.alloc(), alloc.alloc()]
        alloc.reclaim = reclaim
        assert alloc.alloc() in (1, 2) and calls == [1]
        alloc.reclaim = None
        with pytest.raises(RuntimeError, match="exhausted"):
            alloc.alloc()


# -- engines under one script ------------------------------------------------


def _script(eng):
    """Cached admissions of a shared system prompt, a partial hit with a
    divergent tail, an enqueue with a hit, an unaligned registered prefix
    through admit and enqueue, then plain admissions that hit the blocks
    the explicit-prefix admission published. Returns the streams and the
    prefill counter after each part."""
    streams, counters = [], []
    for tail in ([5, 17], [61, 3], [5, 17], [88, 24]):
        rid = eng.admit(SYSTEM + tail)
        for _ in range(3):
            eng.step()
        streams.append(eng.release(rid))
    counters.append(eng.prefilled_tokens_total)
    ra = eng.admit(SYSTEM[:4] + [5, 17, 42])          # block 0 + new tail
    for _ in range(3):
        eng.step()
    streams.append(eng.release(ra))
    counters.append(eng.prefilled_tokens_total)
    rq = eng.enqueue(SYSTEM + [5, 17, 42, 9])
    while len(eng.stream(rq)) < 4:          # 1 chunk cached, 4 uncached
        eng.step()
    streams.append(eng.release(rq))
    counters.append(eng.prefilled_tokens_total)
    pid = eng.register_prefix(SYSTEM[:6])              # 1 full block + 2
    r1 = eng.admit([5, 17, 42], prefix=pid)
    r2 = eng.enqueue([61], prefix=pid)
    for _ in range(5):
        eng.step()
    streams += [eng.release(r1), eng.release(r2)]
    counters.append(eng.prefilled_tokens_total)
    rb = eng.admit(SYSTEM[:6] + [5, 17, 61])
    eng.release_prefix(pid)
    for _ in range(3):
        eng.step()
    streams.append(eng.release(rb))
    counters.append(eng.prefilled_tokens_total)
    return streams, counters, eng.stats()


def _strip(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "duration_ms")}
            for r in records]


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg, tree, params = _models()
    jrec = jtel.FlightRecorder(path="", trace_id="")
    out = {"jax": _script(js.ServingEngine(tree, jcfg, **ENGINE,
                                           prefix_cache=True,
                                           recorder=jrec)),
           "jax_uncached": _script(js.ServingEngine(tree, jcfg, **ENGINE)),
           "jax_records": _strip(jrec.records),
           "jax_summary": jrec.summary()}
    for path in PATHS:
        for cached in (True, False):
            trec = ttel.FlightRecorder(path="", trace_id="")
            eng = ts.ServingEngine(
                params, tcfg, **ENGINE, prefix_cache=cached, recorder=trec,
                paged_kernel=path == "paged", device="cpu")
            key = path if cached else f"{path}_uncached"
            out[key] = _script(eng)
            out[key + "_records"] = _strip(trec.records)
            out[key + "_summary"] = trec.summary()
            out[key + "_engine"] = eng
    return out


@pytest.mark.parametrize("path", PATHS)
def test_cached_streams_equal_jax(runs, path):
    """Cached vs uncached, explicit prefix, partial hit, enqueue with a
    hit: every greedy stream equals the JAX engine's."""
    want = runs["jax"][0]
    assert runs[path][0] == want
    assert all(len(s) >= 4 for s in want)


@pytest.mark.parametrize("path", PATHS)
def test_uncached_streams_equal_cached(runs, path):
    assert runs[f"{path}_uncached"][0] == runs["jax"][0]
    assert runs["jax_uncached"][0] == runs["jax"][0]


@pytest.mark.parametrize("path", PATHS)
def test_prefilled_tokens_equal_jax(runs, path):
    got, want = runs[path][1], runs["jax"][1]
    assert got == want
    # cold 14, then three warm tails of 2; a 3-token tail after block 0;
    # the enqueue's 4-token tail; the prefix admissions: a 3-token prompt
    # and, chunked, the prefix's unaligned 2 tokens and a 1-token prompt;
    # a 1-token tail over the blocks the explicit admission published
    assert want == [20, 23, 27, 33, 34]
    assert runs[f"{path}_uncached"][1] == runs["jax_uncached"][1]
    assert runs["jax_uncached"][1][0] == 4 * 14


@pytest.mark.parametrize("path", PATHS)
def test_stats_equal_jax(runs, path):
    """stats() key for key, value for value: what the agent's serving
    gauges read (the kernel path names itself)."""
    want = dict(runs["jax"][2], paged_kernel=path == "paged")
    assert runs[path][2] == want
    assert want["prefix_cache"]["hits"] == 6
    want_off = dict(runs["jax_uncached"][2], paged_kernel=path == "paged")
    assert runs[f"{path}_uncached"][2] == want_off
    assert "prefix_cache" not in want_off


@pytest.mark.parametrize("path", PATHS)
def test_flight_records_carry_cache_fields_as_jax(runs, path):
    want = runs["jax_records"]
    assert runs[path + "_records"] == want
    admits = [r for r in want if r["kind"] == "serving_admit"]
    assert [r["prefix_cache_hit"] for r in admits][:4] == [
        False, True, True, True]
    assert admits[1]["cached_tokens"] == 12
    keys = ("serving_admits", "prefix_cache_hit_rate",
            "prefix_cache_tokens_saved")
    got = {k: runs[path + "_summary"][k] for k in keys}
    assert got == {k: runs["jax_summary"][k] for k in keys}
    # admit() records (enqueue() does not): 4 + 1 + 2
    assert got["serving_admits"] == 7 and got["prefix_cache_tokens_saved"] > 0


@pytest.mark.parametrize("path", PATHS)
def test_cache_blocks_outlive_requests_and_clear(runs, path):
    eng = runs[path + "_engine"]
    cache = eng._prefix_cache
    assert eng.used_blocks == cache.cached_blocks > 0
    assert cache.clear() > 0 and eng.used_blocks == 0
    assert runs[path + "_uncached_engine"].used_blocks == 0


def test_serving_gauges_read_port_stats():
    """The port's serving gauges (its own AgentMetrics, whose families are
    the agent's) read the port engine's stats()."""
    from prometheus_client import CollectorRegistry, generate_latest

    from elastic_tpu_agent_torch.metrics import AgentMetrics

    _, tcfg, _, params = _models()
    eng = ts.ServingEngine(params, tcfg, **ENGINE, prefix_cache=True,
                           device="cpu")
    eng.release(eng.admit(SYSTEM + [5, 17]))
    rid = eng.admit(SYSTEM + [61, 3])
    metrics = AgentMetrics(registry=CollectorRegistry())
    metrics.attach_serving(eng.stats)
    text = generate_latest(metrics._registry).decode()
    assert "elastic_tpu_serving_prefix_cache_hits 1.0" in text
    assert "elastic_tpu_serving_prefix_cache_hit_rate 0.5" in text
    assert (f"elastic_tpu_serving_pool_used_blocks {float(eng.used_blocks)}"
            in text)
    eng.release(rid)
    json.dumps(eng.stats())


# -- pool pressure, failed admissions ----------------------------------------


def _pressure(eng):
    """Pool pressure evicts cache-only blocks LRU instead of failing; a
    failed admission (no slot; the pool exhausted with every cached block
    live) moves no counter and leaks no block."""
    trace = []
    r1 = eng.admit(SYSTEM)                  # 3 full blocks + write block
    for _ in range(2):
        eng.step()
    trace.append(eng.release(r1))
    trace.append(eng.used_blocks)           # the cache's holdings: 3
    r2 = eng.admit([5, 17, 42])
    big = [80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92]
    r3 = eng.admit(big)                     # needs the cache's blocks
    trace.append(eng.stats())
    with pytest.raises(ValueError, match="free slot") as e:
        eng.admit(SYSTEM + [1])
    trace += [str(e.value), eng.stats()]
    for _ in range(3):
        eng.step()
    trace += [eng.release(r2), eng.release(r3), eng._prefix_cache.clear()]
    r4 = eng.admit(SYSTEM[:8] + [3])        # its 2 published blocks live
    r5 = eng.admit([4, 5])
    eng.release(r5)
    trace.append(eng.stats())
    with pytest.raises(ValueError, match="pool exhausted") as e:
        eng.admit(list(range(40, 56)))      # 5 blocks; 4 free, none evictable
    trace += [str(e.value), eng.stats()]
    eng.step()
    trace.append(eng.release(r4))
    return trace


@pytest.fixture(scope="module")
def pressure():
    jcfg, tcfg, tree, params = _models()
    kw = dict(ENGINE, prefix_cache=True, pool_blocks=8)
    out = {"jax": _pressure(js.ServingEngine(tree, jcfg, **kw))}
    for path in PATHS:
        out[path] = _pressure(ts.ServingEngine(
            params, tcfg, **kw, paged_kernel=path == "paged", device="cpu"))
    return out


@pytest.mark.parametrize("path", PATHS)
def test_eviction_under_pool_pressure_matches_jax(pressure, path):
    want = pressure["jax"]
    got = [dict(x, paged_kernel=False) if isinstance(x, dict) else x
           for x in pressure[path]]
    assert got == want
    assert want[1] == 3 and want[2]["prefix_cache"]["evictions"] >= 1
    assert len(want[-1]) == 2


@pytest.mark.parametrize("path", PATHS)
def test_failed_admission_never_counts_as_hit(pressure, path):
    trace = pressure[path]
    assert trace[4] == trace[2]             # refused for want of a slot
    assert trace[10] == trace[8]            # refused for want of blocks
    assert trace[8]["prefix_cache"]["cached_blocks"] == 2
    assert trace[8]["used_blocks"] == 3

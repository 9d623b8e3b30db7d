"""The port's perf-regression ledger (``elastic_tpu_agent_torch/
bench_history.py``) and its CLI's ``perf-gate`` against the agent's, on
the same histories: the seeded trajectories of ``tests/test_latency.py``,
regressions of every tracked kind, an ``--include`` file, the committed
``BENCH_r01-05.json`` (read as data) and malformed rounds. For each, what
``load_history``, ``validate_history``, ``series`` over the four tracked
tuples, ``perf_gate`` and each self-test give (or raise) is equal, string
for string; and the two CLIs parse the same flags and exit with the same
code and stderr."""

import json
import os

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import bench_history as jbh  # noqa: E402
from elastic_tpu_agent import cli as jcli  # noqa: E402
from elastic_tpu_agent_torch import bench_history as tbh  # noqa: E402
from elastic_tpu_agent_torch import cli as tcli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _round(n, allocate=0.6, prestart=1.0, bind50=1.5, bind99=3.0):
    """tests/test_latency.py's round."""
    return {
        "n": n,
        "cmd": "python3 bench.py",
        "rc": 0,
        "parsed": {
            "metric": "allocate_p50_latency",
            "value": allocate,
            "unit": "ms",
            "extra": {
                "ours": {
                    "allocate_p50_ms": allocate,
                    "prestart_p50_ms": prestart,
                    "bind_p50_ms": bind50,
                    "bind_p99_ms": bind99,
                },
            },
        },
    }


def _with(r, block, **leaves):
    r["parsed"]["extra"][block] = dict(leaves)
    return r


def _edit(fn, n=2):
    r = _round(n)
    fn(r)
    return r


def _pop(*path):
    def fn(r):
        node = r
        for key in path[:-1]:
            node = node[key]
        del node[path[-1]]
    return fn


def _set(value, *path):
    def fn(r):
        node = r
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return fn


OURS = ("parsed", "extra", "ours")

# name -> (files written as BENCH_r<NN>.json or under their own name,
# files passed as --include)
CASES = {
    "load_validate_series": [_round(1), _round(2, bind50=1.7), _round(3)],
    "noisy_flat": [_round(1), _round(2, bind50=1.9), _round(3, bind50=1.4),
                   _round(4, bind50=2.0), _round(5, bind50=1.8)],
    "bind_regression": [_round(1), _round(2), _round(3),
                        _round(4, bind50=9.0)],
    "bind_p99_regression": [_round(1), _round(2), _round(3),
                            _round(4, bind99=40.0)],
    "submillisecond_floor": [_round(1, allocate=0.10),
                             _round(2, allocate=0.10),
                             _round(3, allocate=0.16)],
    "one_round": [_round(1)],
    "event_core_regression": [
        _round(1), _round(2),
        *(_with(_round(n), "event_core", event_to_repair_ms=e2r,
                bind_churn_p99_ms=5.0)
          for n, e2r in ((3, 20.0), (4, 22.0), (5, 180.0)))],
    "migration_ms_regression": [
        _round(1),
        *(_with(_round(n), "migration_core", migration_downtime_ms=ms,
                migration_delta_bytes_ratio=0.12)
          for n, ms in ((2, 180.0), (3, 220.0), (4, 200.0), (5, 2000.0)))],
    "migration_ratio_regression": [
        *(_with(_round(n), "migration_core", migration_downtime_ms=200.0,
                migration_delta_bytes_ratio=ratio)
          for n, ratio in ((1, 0.12), (2, 0.15), (3, 0.13), (4, 0.9)))],
    "ratio_collapse": [
        *(_with(_round(n), "request_obs", prefill_reduction=v)
          for n, v in ((1, 4.0), (2, 4.2), (3, 4.1), (4, 0.5))),
        _with(_round(5), "qos_repartition", live_speedup=1.8)],
    "ratio_steady": [
        *(_with(_round(n), "request_obs", prefill_reduction=v)
          for n, v in ((1, 4.0), (2, 4.2), (3, 4.1)))],
    "unreadable_file": [_round(1), _round(2), "{not json"],
    "non_object_round": [_round(1), [1, 2, 3]],
    "non_object_newest_ours": [_round(1), _edit(_set([1], *OURS))],
    "missing_n": [_round(1), _edit(_pop("n"))],
    "missing_cmd": [_round(1), _edit(_pop("cmd"))],
    "missing_rc": [_round(1), _edit(_pop("rc"))],
    "string_rc": [_round(1), _edit(_set("zero", "rc"))],
    "missing_parsed": [_round(1), _edit(_pop("parsed"))],
    "missing_metric": [_round(1), _edit(_pop("parsed", "metric"))],
    "bool_value": [_round(1), _edit(_set(True, "parsed", "value"))],
    "non_object_extra": [_round(1), _edit(_set([], "parsed", "extra"))],
    "missing_ours_leaf": [_round(1), _edit(_pop(*OURS, "bind_p99_ms"))],
    "negative_ours_leaf": [_round(1),
                           _edit(_set(-1.0, *OURS, "prestart_p50_ms"))],
    "duplicate_n": [_round(1), _round(2), {"dup_of": 1}],
}


def _write(d, rounds):
    """Each round as BENCH_r<NN>.json (NN its index + 1); a string is
    written as it stands; ``{"dup_of": n}`` is round n again under
    BENCH_r99.json."""
    for i, r in enumerate(rounds):
        name = f"BENCH_r{i + 1:02d}.json"
        if isinstance(r, str):
            text = r
        elif isinstance(r, dict) and "dup_of" in r:
            name, text = "BENCH_r99.json", json.dumps(_round(r["dup_of"]))
        else:
            text = json.dumps(r)
        (d / name).write_text(text)


def _outcome(fn, *args, **kw):
    """What fn gives, or the exception it raises, as comparable data."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the raise is the outcome
        return ("raises", type(e).__name__, str(e))


def _ledger(bh, root, include=None):
    loaded = _outcome(bh.load_history, root, include=include)
    if loaded[0] != "ok":
        return {"load_history": loaded}
    rounds, problems = loaded[1]
    out = {"load_history": loaded,
           "validate_history": _outcome(bh.validate_history, rounds)}
    for name in ("TRACKED", "TRACKED_RATIOS", "TRACKED_EVENT",
                 "TRACKED_MIGRATION"):
        out[f"series {name}"] = _outcome(bh.series, rounds,
                                         getattr(bh, name))
    out["perf_gate"] = _outcome(bh.perf_gate, rounds)
    out["perf_gate tight"] = _outcome(bh.perf_gate, rounds, tolerance=0.1,
                                      floor_ms=0.0, window=1)
    for test in ("self_test", "ratio_self_test", "event_self_test",
                 "migration_self_test"):
        out[test] = _outcome(getattr(bh, test), rounds)
    return out


def test_constants_and_defaults_equal_the_agents():
    names = ("TRACKED", "TRACKED_RATIOS", "TRACKED_EVENT",
             "TRACKED_MIGRATION", "DEFAULT_TOLERANCE", "DEFAULT_FLOOR_MS",
             "DEFAULT_FLOOR_RATIO", "DEFAULT_WINDOW", "MIN_ROUNDS")
    assert {n: getattr(tbh, n) for n in names} == {
        n: getattr(jbh, n) for n in names}
    assert (tbh.DEFAULT_TOLERANCE, tbh.DEFAULT_FLOOR_MS,
            tbh.DEFAULT_FLOOR_RATIO, tbh.DEFAULT_WINDOW,
            tbh.MIN_ROUNDS) == (0.5, 0.25, 0.05, 3, 2)


@pytest.mark.parametrize("case", [*CASES, "include", "committed"])
def test_ledger_equals_the_agents(case, tmp_path):
    include = None
    if case == "committed":
        root = ROOT                     # BENCH_r01-05.json, read as data
    else:
        root = str(tmp_path)
        if case == "include":
            _write(tmp_path, [_round(1), _round(2), _round(3)])
            extra = tmp_path / "smoke.json"
            extra.write_text(json.dumps(_round(4, bind99=40.0)))
            include = [str(extra), str(tmp_path / "absent.json")]
        else:
            _write(tmp_path, CASES[case])
    got, want = _ledger(tbh, root, include), _ledger(jbh, root, include)
    assert got == want
    if case == "committed":
        assert len(got["load_history"][1][0]) == 5
        assert got["perf_gate"] == got["self_test"] == ("ok", [])


# flags given in full, and each CLI run's arguments after --root
FULL_FLAGS = ["--root", "r", "--include", "a.json", "--include", "b.json",
              "--tolerance", "0.3", "--floor-ms", "1.5", "--window", "5",
              "--series", "--self-test"]


def test_perf_gate_flags_equal_the_agents():
    assert (vars(tcli.parse_perf_gate_args([]))
            == vars(jcli.parse_perf_gate_args([])))
    assert (vars(tcli.parse_perf_gate_args(FULL_FLAGS))
            == vars(jcli.parse_perf_gate_args(FULL_FLAGS)))
    assert vars(tcli.parse_perf_gate_args([])) == dict(
        root=".", include=[], tolerance=0.5, floor_ms=0.25, window=3,
        series=False, self_test=False)


@pytest.mark.parametrize("history,argv,rc", [
    ("three", ["--self-test"], 0),
    ("three", ["--series", "--self-test"], 0),
    ("regressed", [], 1),
    ("regressed", ["--series", "--self-test"], 1),
    ("three", ["--include", "{d}/BENCH_r04.json.new"], 1),
    ("regressed", ["--tolerance", "20", "--floor-ms", "0", "--window", "1"],
     0),
    ("malformed", ["--self-test"], 1),
])
def test_perf_gate_cli_equals_the_agents(history, argv, rc, tmp_path,
                                         capsys):
    """Green with --self-test, red on a seeded regression (the newest
    bind p99 at 40 ms), red on a malformed round: the same exit code and
    the same stderr from both CLIs."""
    _write(tmp_path, [_round(1), _round(2), _round(3)])
    (tmp_path / "BENCH_r04.json.new").write_text(
        json.dumps(_round(4, bind99=40.0)))
    if history == "regressed":
        _write(tmp_path, [_round(1), _round(2), _round(3),
                          _round(4, bind99=40.0)])
    elif history == "malformed":
        (tmp_path / "BENCH_r04.json").write_text(
            json.dumps(_edit(_set(-1.0, *OURS, "bind_p50_ms"), n=4)))
    args = ["perf-gate", "--root", str(tmp_path),
            *(a.format(d=tmp_path) for a in argv)]
    capsys.readouterr()
    got_rc = tcli.main(args)
    got = capsys.readouterr()
    want_rc = jcli.main(args)
    want = capsys.readouterr()
    assert (got_rc, got.err, got.out) == (want_rc, want.err, want.out)
    assert got_rc == rc
    lines = got.err.strip().splitlines()
    prefix = "perf-gate OK:" if rc == 0 else "PERF-GATE:"
    assert any(line.startswith(prefix) for line in lines)

"""Both cells through the whole harness on the card: at the tiny sizes,
untraced and traced, the kernels run, every metric is read, and the check
holds; at the cells' own sizes, with ``--control``, the program comes out
correct and the control and each planted fault not correct under the
same limits (``python -m pytest -m cuda benchmark/tests``; skips without
a card)."""

import json

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec
from benchmark.tests import tiny

BENCH = spec.load_benchmark()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, monkeypatch, capsys, cell, trace):
    tiny.install(monkeypatch)
    rc = bench_run.main(["--workload", cell, "--seed", str(2**40 + trace),
                         "--seconds", "3", "--trace", str(trace)])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, section)}
    assert set(res["metrics"]) == want, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


# a window long enough to finish the serving mix's longest answers
CONTROL_SECONDS = {"starcoder2-3b.complete": "20", "gpt2-xl.train": "3"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_controls_fail_at_the_cells_size(card, capsys, cell):
    rc = bench_run.main(["--workload", cell, "--seed", str(2**35 + 17),
                         "--seconds", CONTROL_SECONDS[cell], "--trace", "0",
                         "--control"])
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    with capsys.disabled():      # the readings, for the record
        print(cell, json.dumps({k: res[k] for k in ("controls", "checks")}))
    assert res["correct"] is True, res["checks"]
    assert res["controls"], err[-3000:]
    for name, c in res["controls"].items():
        assert c["correct"] is False, (name, c["checks"])
    assert rc == 0, err[-3000:]

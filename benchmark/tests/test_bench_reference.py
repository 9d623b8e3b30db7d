"""The float32 reference against the port's CPU path on tiny copies of
both configurations: the forward (RoPE, grouped kv heads, the window;
learned positions), the layer-by-layer form the serving check runs, the
loss and its gradients, and AdamW."""

import pytest
import torch

from benchmark.drivers.common import port_config
from benchmark.harness.model import make_head, make_layer, make_params, sizes
from benchmark.reference import model as ref
from benchmark.tests import tiny

NAMES = ["starcoder2-3b", "gpt2-xl"]


def _f32_sizes(name):
    return dict(sizes(tiny.config(name)), dtype="float32")


def _close(a, b, tol=2e-5):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * max(scale, 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_port(name):
    from elastic_tpu_agent_torch.workloads.transformer import forward

    s = _f32_sizes(name)
    tree = make_params(torch, s, 11, "cpu", torch.float32)
    seq = min(s["max_seq"], 80)
    tokens = torch.randint(0, s["vocab"], (2, seq),
                           generator=torch.Generator().manual_seed(1))
    if s["window"]:
        assert seq > s["window"]     # the window binds
    got = forward(tree, tokens, port_config(torch, s), device="cpu")
    _close(ref.forward(tree, tokens, s), got)


@pytest.mark.parametrize("name", NAMES)
def test_layer_by_layer_equals_whole(name):
    s = _f32_sizes(name)
    tree = make_params(torch, s, 12, "cpu", torch.float32)
    seqs = [torch.randint(0, s["vocab"], (n,)) for n in (9, 30)]
    got = ref.served_logits(
        seqs, [3, 20], s, make_head(torch, s, 12, "cpu", torch.float32),
        lambda i: make_layer(torch, s, 12, i, "cpu", torch.float32))
    for x, t, p in zip(got, seqs, [3, 20]):
        _close(x, ref.forward(tree, t[None], s)[0, p:], 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_port(name):
    from elastic_tpu_agent_torch.workloads import transformer as tf

    s = _f32_sizes(name)
    tree = make_params(torch, s, 13, "cpu", torch.float32)
    seq = min(s["max_seq"] - 1, 48)
    tokens = torch.randint(0, s["vocab"], (4, seq + 1),
                           generator=torch.Generator().manual_seed(2))
    loss, grads = tf.loss_and_grads(tree, tokens, port_config(torch, s),
                                    device="cpu")
    want_loss, want = ref.loss_and_grads(tree, tokens, s, rows_per_block=3)
    assert abs(float(loss) - want_loss) < 1e-5
    for path in ref.leaf_paths(tree):
        _close(ref.leaf(grads, path), want[path], 1e-4)


def test_adamw_matches_port():
    from elastic_tpu_agent_torch.workloads.transformer import AdamW

    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    port, opt = AdamW(1e-3), ref.AdamW(1e-3, weight_decay=1e-4)
    state = port.init(params)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
        port.update_(grads, state, params)
        opt.step(mine, grads)
    for k in params:
        _close(mine[k], params[k], 1e-6)
    assert AdamW().weight_decay == 1e-4   # what the training cell states

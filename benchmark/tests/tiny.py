"""Tiny copies of the benchmark's configurations and cells, for runs of
the whole harness on the CPU (and short ones on the card): the same keys,
the same kinds of layer and head_dim 64, which the port's kernels take,
at sizes a test run holds."""

from __future__ import annotations

import copy

from benchmark.harness import spec

_load_config, _load_cell = spec.load_config, spec.load_cell

# initializer_range 1/sqrt(hidden): logits of about unit spread, as the
# published widths give them at their own init ranges
TINY_KEYS = {
    "starcoder2-3b": {"hidden_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 2, "num_key_value_heads": 1,
                      "intermediate_size": 128, "vocab_size": 256,
                      "max_position_embeddings": 96, "sliding_window": 40,
                      "initializer_range": 0.088},
    "gpt2-xl": {"n_embd": 128, "n_layer": 2, "n_head": 2, "n_inner": 256,
                "vocab_size": 256, "n_positions": 32,
                "initializer_range": 0.088},
}

TINY_CELLS = {
    "starcoder2-3b.complete": {
        "engine": {"slots": 4, "max_len": 96, "prompt_buckets": [16, 32, 64],
                   "block_size": 16},
        "traffic": {"rate_per_s": 12.0,
                    "prompt_len": {"dist": "log_uniform", "min": 9, "max": 64},
                    "output_len": {"dist": "log_uniform", "min": 2,
                                   "max": 12}},
        "check": {"sample_tokens": 400, "max_requests": 32},
    },
    "gpt2-xl.train": {
        "traffic": {"rows": 4, "seq": 32},
        "check": {"rows_per_block": 2},
    },
}


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def config(name: str) -> dict:
    return _merge(_load_config(name), TINY_KEYS[name])


def cell(name: str) -> dict:
    return _merge(_load_cell(name), TINY_CELLS[name])


def install(monkeypatch) -> None:
    """Make the harness load the tiny copies by name."""
    monkeypatch.setattr(spec, "load_config", config)
    monkeypatch.setattr(spec, "load_cell", cell)

"""A configuration file's sizes, the parameter tree in the port's layout,
and the weights, made on the device from the seed.

The benchmark makes the weights and hands the same to the program and to
the reference; the reference makes them again from the seed. Each group
(the embedding tables, one layer) is one ``normal_`` call on one flat
buffer from its own generator, and its leaves are views of it."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from .seeds import derive

DTYPES = ("float32", "bfloat16")


def sizes(config: Dict) -> Dict:
    """The sizes a run needs. A configuration file holds the model's own
    keys as run, at its top level; its ``port`` block names, for each size
    the port takes, the key that holds it (a key whose value is null takes
    the file's ``assumed`` value) and gives the port's position kind and
    compute dtype."""
    port = config["port"]

    def get(field, default=None):
        key = port["keys"].get(field)
        if key is None:
            return default
        value = config.get(key)
        return config["assumed"][key] if value is None else value

    d, n = get("d_model"), get("n_heads")
    g = get("n_kv_heads") or n
    if d % n or n % g:
        raise ValueError(f"d_model {d}, heads {n}, kv heads {g}")
    return dict(
        vocab=get("vocab"), d=d, n=n, g=g, h=d // n, layers=get("n_layers"),
        ff=get("d_ff"), max_seq=get("max_seq"), pos=port["pos"],
        rope_theta=float(get("rope_theta", 10000.0)),
        window=int(get("window", 0) or 0), norm_eps=float(get("norm_eps")),
        init_std=float(get("init_std")), dtype=port["dtype"],
    )


def layer_shapes(s: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """One layer's matrices in the port's layout, in buffer order."""
    d, n, g, h = s["d"], s["n"], s["g"], s["h"]
    qkv = ([("wq", (d, n, h)), ("wkv", (d, 2, g, h))] if g != n
           else [("wqkv", (d, 3, n, h))])
    return qkv + [("wo", (n, h, d)), ("w1", (d, s["ff"])),
                  ("w2", (s["ff"], d))]


def head_shapes(s: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    out = [("embed", (s["vocab"], s["d"])), ("lm_head", (s["d"], s["vocab"]))]
    if s["pos"] == "learned":
        out.append(("pos_embed", (s["max_seq"], s["d"])))
    return out


def param_count(s: Dict) -> Dict[str, int]:
    """Parameters of the model as the port holds it: ``total``, and
    ``non_embedding`` (without the embedding and position tables; the
    output head counted), the N of the 2N and 6N rules."""
    layer = sum(math.prod(sh) for _, sh in layer_shapes(s)) + 2 * s["d"]
    head = sum(math.prod(sh) for _, sh in head_shapes(s)) + s["d"]
    tables = s["vocab"] * s["d"] + (
        s["max_seq"] * s["d"] if s["pos"] == "learned" else 0)
    total = s["layers"] * layer + head
    return dict(total=total, non_embedding=total - tables)


def _views(torch, shapes, flat) -> Dict:
    out, at = {}, 0
    for name, sh in shapes:
        k = math.prod(sh)
        out[name] = flat[at:at + k].view(sh)
        at += k
    return out


def _group(torch, shapes, seed, tag, std, device, dtype) -> Dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", tag))
    flat = torch.empty(sum(math.prod(sh) for _, sh in shapes),
                       device=device, dtype=dtype)
    flat.normal_(0.0, std, generator=gen)
    return _views(torch, shapes, flat)


def make_layer(torch, s: Dict, seed: int, i: int, device, dtype) -> Dict:
    layer = _group(torch, layer_shapes(s), seed, f"layer{i}",
                   s["init_std"], device, dtype)
    layer["ln1_scale"] = torch.ones(s["d"], device=device, dtype=dtype)
    layer["ln2_scale"] = torch.ones(s["d"], device=device, dtype=dtype)
    return layer


def make_head(torch, s: Dict, seed: int, device, dtype) -> Dict:
    head = _group(torch, head_shapes(s), seed, "head", s["init_std"],
                  device, dtype)
    head["final_norm_scale"] = torch.ones(s["d"], device=device, dtype=dtype)
    return head


def make_params(torch, s: Dict, seed: int, device, dtype) -> Dict:
    """The whole tree in the port's layout: unit norm scales, every
    matrix normal(0, init_std)."""
    tree = make_head(torch, s, seed, device, dtype)
    tree["layers"] = [make_layer(torch, s, seed, i, device, dtype)
                      for i in range(s["layers"])]
    return tree


def torch_dtype(torch, name: str):
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} not in {DTYPES}")
    return getattr(torch, name)

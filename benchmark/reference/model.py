"""Plain float32 decoder, written from the models' published description
as the port runs them (a configuration file's ``departures`` list where
that differs from the source): token embedding, learned positions or
rotary embeddings, pre-norm RMSNorm blocks of causal (optionally
sliding-window) grouped-query attention and a tanh-GELU MLP, a final
norm and an untied output head.

Plain ``torch`` operations only, no kernel, cache or batching of the
program; TF32 is switched off wherever this runs (``no_tf32``). Every
matrix product goes through ``mm``, so that the control can put a
lower-precision product in its place (``quant.py``). Parameters are the
tree the benchmark makes (``harness.model``), in the port's layout."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


@contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x [b, s, heads, h]: each interleaved pair
    (x[2i], x[2i+1]) turns by position * theta^(-2i/h)."""
    h = x.shape[-1]
    freqs = theta ** (-torch.arange(0, h, 2, dtype=torch.float32,
                                    device=x.device) / h)
    angle = positions.to(torch.float32)[:, None] * freqs       # [s, h/2]
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).flatten(-2)


def attention(q, k, v, window: int = 0):
    """Causal attention of q [b, s, n, h] over k, v [b, s, g, h]: query
    head i reads kv head i // (n / g); with ``window`` > 0 a query at i
    sees keys j with i - window < j <= i."""
    b, s, n, h = q.shape
    r = n // k.shape[2]
    k = k.repeat_interleave(r, dim=2)
    v = v.repeat_interleave(r, dim=2)
    scores = torch.einsum("bqnh,bknh->bnqk", q, k) / math.sqrt(h)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None]
    keep = j <= i
    if window > 0:
        keep = keep & (i - j < window)
    scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("bnqk,bknh->bqnh", torch.softmax(scores, -1), v)


def embed(tree: Dict, tokens: torch.Tensor, s: Dict) -> torch.Tensor:
    x = tree["embed"][tokens]
    if s["pos"] == "learned":
        x = x + tree["pos_embed"][: tokens.shape[1]][None]
    return x


def block(x: torch.Tensor, layer: Dict, s: Dict, mm: MM = f32_mm):
    """One pre-norm layer on x [b, seq, d]."""
    b, seq, d = x.shape
    n, g, h = s["n"], s["g"], s["h"]
    a = rmsnorm(x, layer["ln1_scale"], s["norm_eps"])
    if "wq" in layer:
        q = mm(a, layer["wq"].reshape(d, n * h)).view(b, seq, n, h)
        kv = mm(a, layer["wkv"].reshape(d, 2 * g * h)).view(b, seq, 2, g, h)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        qkv = mm(a, layer["wqkv"].reshape(d, 3 * n * h)).view(
            b, seq, 3, n, h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if s["pos"] == "rope":
        pos = torch.arange(seq, device=x.device)
        q, k = rope(q, pos, s["rope_theta"]), rope(k, pos, s["rope_theta"])
    o = attention(q, k, v, s["window"]).reshape(b, seq, n * h)
    x = x + mm(o, layer["wo"].reshape(n * h, d))
    a = rmsnorm(x, layer["ln2_scale"], s["norm_eps"])
    return x + mm(F.gelu(mm(a, layer["w1"]), approximate="tanh"),
                  layer["w2"])


def head(x: torch.Tensor, tree: Dict, s: Dict, mm: MM = f32_mm):
    return mm(rmsnorm(x, tree["final_norm_scale"], s["norm_eps"]),
              tree["lm_head"])


def forward(tree: Dict, tokens: torch.Tensor, s: Dict, mm: MM = f32_mm):
    """Logits [b, seq, vocab] of tokens [b, seq]."""
    x = embed(tree, tokens, s)
    for layer in tree["layers"]:
        x = block(x, layer, s, mm)
    return head(x, tree, s, mm)


def served_logits(
    seqs: Sequence[torch.Tensor], from_pos: Sequence[int], s: Dict,
    head_tree: Dict, layer_of: Callable[[int], Dict], mm: MM = f32_mm,
) -> List[torch.Tensor]:
    """Logits at positions ``from_pos[i]:`` of each sequence ``seqs[i]``
    ([seq] ids), layer by layer: ``layer_of(i)`` gives layer i's float32
    weights, made once for all sequences and dropped after."""
    xs = [embed(head_tree, t[None], s) for t in seqs]
    for i in range(s["layers"]):
        layer = layer_of(i)
        xs = [block(x, layer, s, mm) for x in xs]
        del layer
    return [head(x[0, p:], head_tree, s, mm) for x, p in zip(xs, from_pos)]


# -- training ----------------------------------------------------------


def leaf_paths(tree: Dict) -> List[Tuple]:
    """Every leaf's path, in one fixed order: the head's leaves by name,
    then each layer's by name."""
    paths = [(k,) for k in sorted(tree) if k != "layers"]
    for i, layer in enumerate(tree["layers"]):
        paths += [("layers", i, k) for k in sorted(layer)]
    return paths


def leaf(tree: Dict, path: Tuple) -> torch.Tensor:
    for p in path:
        tree = tree[p]
    return tree


class AdamW:
    """AdamW as optax's ``adamw`` computes it: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, decoupled weight decay ``weight_decay``
    times the parameter, bias correction from the step count."""

    def __init__(self, lr: float, weight_decay: float, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t = 0
        self.m: Dict = {}
        self.v: Dict = {}

    @torch.no_grad()
    def step(self, params: Dict[Tuple, torch.Tensor],
             grads: Dict[Tuple, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt_().add_(self.eps))
            p.sub_(self.lr * (upd + self.wd * p))


def loss_and_grads(tree: Dict, tokens: torch.Tensor, s: Dict,
                   rows_per_block: int, mm: MM = f32_mm):
    """Mean next-token cross entropy of tokens [b, seq+1] and its gradient
    by leaf path, worked in blocks of rows (each block's summed loss over
    all b * seq targets, gradients summed)."""
    paths = leaf_paths(tree)
    leaves = [leaf(tree, p).requires_grad_() for p in paths]
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    grads = None
    for at in range(0, tokens.shape[0], rows_per_block):
        rows = tokens[at:at + rows_per_block]
        with torch.enable_grad():
            logits = forward(tree, rows[:, :-1], s, mm)
            loss = F.cross_entropy(logits.flatten(0, 1), rows[:, 1:].flatten(),
                                   reduction="sum") / count
            part = torch.autograd.grad(loss, leaves)
        total += float(loss.detach())
        grads = list(part) if grads is None else [
            a.add_(b) for a, b in zip(grads, part)]
        del logits, loss, part
    for x in leaves:
        x.requires_grad_(False)
    return total, dict(zip(paths, grads))

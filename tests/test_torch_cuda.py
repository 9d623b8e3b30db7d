"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc (sm_90a); elsewhere they skip.
Run them there with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances, as in chip_smoke.py: float32 outputs 1e-4 (summation order
only); bfloat16 flash outputs 8e-3 (both versions round p to bf16 before
P.V, so they differ by about an output ulp); bfloat16 paged outputs 1e-3
(f32 math, one rounding of the output); lse 1e-3 (f32 exp/log order).
The backward kernels are held, for each of dq, dk, dv, by max |kernel -
plain| over max |plain| and by mean |kernel - plain| over mean |plain|:
float32 1e-5 for both; bfloat16 BWD_BF16_TOL, two ulps of the largest
element, and BWD_BF16_MEAN_TOL (both versions round p and ds to bf16
where the TPU kernels do, so they differ by an output ulp in a few
elements; chip_smoke.py's limits, set from sound and planted-fault
readings)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elastic_tpu_agent_torch.workloads import attention as A  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    paged_attention as PA,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, bf16):
    return 1e-4 if dtype == torch.float32 else bf16


@pytest.mark.parametrize(
    "b,s,n,g,h,dtype,causal,window",
    [
        (2, 256, 8, 8, 64, torch.bfloat16, True, 0),
        (2, 256, 8, 8, 64, torch.float32, True, 0),
        (1, 200, 4, 4, 128, torch.bfloat16, True, 0),   # ragged last tile
        (1, 200, 4, 2, 128, torch.float32, False, 0),   # GQA, non-causal
        (2, 256, 4, 4, 64, torch.bfloat16, True, 48),   # sliding window
        (1, 130, 2, 1, 64, torch.float32, True, 100),
        # the bf16 kernel's edges: one row, a tile short or one past, TMA's
        # zero fill past the end, window 1 (only the diagonal)
        (2, 1, 4, 4, 64, torch.bfloat16, True, 0),
        (1, 1, 2, 2, 128, torch.bfloat16, False, 0),
        (2, 63, 4, 2, 64, torch.bfloat16, True, 0),
        (2, 65, 4, 4, 128, torch.bfloat16, True, 0),
        (1, 65, 4, 1, 64, torch.bfloat16, False, 0),
        (2, 200, 8, 2, 64, torch.bfloat16, True, 0),
        (2, 200, 4, 4, 64, torch.bfloat16, True, 1),
        (1, 130, 4, 2, 128, torch.bfloat16, True, 1),
        (1, 63, 2, 2, 64, torch.float32, True, 1),
    ],
)
def test_flash_kernel_matches_plain(dev, b, s, n, g, h, dtype, causal, window):
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(b, s, n, h)), dtype=dtype, device=dev)
    k = torch.tensor(rng.normal(size=(b, s, g, h)), dtype=dtype, device=dev)
    v = torch.tensor(rng.normal(size=(b, s, g, h)), dtype=dtype, device=dev)
    fc = A.FlashConfig(causal=causal, window=window)
    o, lse = A.flash_attention_with_lse(q, k, v, fc)
    o_ref, lse_ref = A.flash_attention_plain(q, k, v, fc)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    assert err <= _tol(dtype, 8e-3)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(dev, dtype):
    """q/k/v as views of one fused [b, s, 3, n, h] projection (the bf16
    kernel's TMA maps take the strides as they are)."""
    rng = np.random.default_rng(1)
    qkv = torch.tensor(
        rng.normal(size=(2, 130, 3, 4, 64)), dtype=dtype, device=dev
    )
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = A.flash_attention_with_lse(q, k, v)
    o_ref, lse_ref = A.flash_attention_plain(q, k, v, A.FlashConfig())
    assert (o.float() - o_ref.float()).abs().max().item() <= _tol(dtype, 8e-3)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def _paged_case(rng, slots, g, r, h, bs, n_blocks, nb, dtype, dev):
    def randn(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)

    q = randn(slots, g * r, h)
    pk, pv = randn(n_blocks, bs, g, h), randn(n_blocks, bs, g, h)
    table = np.zeros((slots, nb), np.int32)
    lengths = np.zeros((slots,), np.int32)
    ids = rng.permutation(np.arange(1, n_blocks))
    cur = 0
    for s in range(slots):
        used = int(rng.integers(1, nb + 1))
        table[s, :used] = ids[cur:cur + used]
        cur += used
        lengths[s] = int(rng.integers(1, used * bs + 1))
    return (q, pk, pv, torch.tensor(table, device=dev),
            torch.tensor(lengths, device=dev))


@pytest.mark.parametrize("g,r", [(8, 1), (2, 4), (1, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("window", [0, 37])
def test_paged_kernel_matches_plain(dev, g, r, dtype, h, window):
    rng = np.random.default_rng(2)
    q, pk, pv, table, lengths = _paged_case(
        rng, 8, g, r, h, 16, 8 * 12 + 1, 12, dtype, dev
    )
    got = PA.paged_decode_attention(
        q, pk, pv, table, lengths, g, window=window
    )
    want = PA.paged_decode_attention_reference(
        q, pk, pv, table, lengths, g, window=window
    )
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, 1e-3)


def test_paged_kernel_skips_nonfinite_masked_entries(dev):
    """Masked positions are skipped, not multiplied by 0: NaN in the junk
    block and past a row's length must not reach the output."""
    rng = np.random.default_rng(3)
    q, pk, pv, table, lengths = _paged_case(
        rng, 4, 2, 2, 64, 16, 4 * 6 + 1, 6, torch.float32, dev
    )
    want = PA.paged_decode_attention_reference(q, pk, pv, table, lengths, 2)
    pk[0], pv[0] = float("nan"), float("nan")
    for s in range(4):
        ln = int(lengths[s])
        blk, off = int(table[s, (ln - 1) // 16]), ln % 16
        if off:
            pk[blk, off:], pv[blk, off:] = float("nan"), float("nan")
    got = PA.paged_decode_attention(q, pk, pv, table, lengths, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


# name: (slots, g, r, h, bs, nb, lengths, window)
PAGED_EDGES = {
    "length0": (4, 2, 2, 64, 16, 6, [0, 5, 96, 0], 0),
    "length0_window": (3, 2, 2, 64, 16, 4, [0, 40, 0], 7),
    "length1": (4, 2, 2, 64, 16, 6, [1, 1, 17, 2], 0),
    # 8 x 8 CTAs: 4 splits; full splits, an empty last one, one block each
    "split_boundary": (8, 8, 1, 64, 16, 32,
                       [128, 256, 384, 512, 48, 80, 16, 64], 0),
    # the window's first position falls inside a split's first block
    "window_in_split": (8, 8, 1, 64, 16, 32,
                        [300, 512, 100, 200, 301, 17, 511, 250], 100),
    "r16_h128_bs64": (2, 1, 16, 128, 64, 8, [512, 130], 0),
    "one_block": (8, 2, 4, 64, 16, 1, [16, 1, 0, 7, 15, 16, 3, 9], 0),
}


def _paged_edge_case(rng, slots, g, r, h, bs, nb, lengths, dtype, dev):
    def randn(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)

    n_blocks = slots * nb + 1
    q = randn(slots, g * r, h)
    pk, pv = randn(n_blocks, bs, g, h), randn(n_blocks, bs, g, h)
    table = np.zeros((slots, nb), np.int32)
    ids = rng.permutation(np.arange(1, n_blocks))
    for s, ln in enumerate(lengths):
        used = max(1, -(-ln // bs)) if ln else int(rng.integers(1, nb + 1))
        table[s, :used] = ids[s * nb:s * nb + used]
    return (q, pk, pv, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(lengths, np.int32), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", sorted(PAGED_EDGES))
def test_paged_kernel_edges(dev, edge, dtype):
    """Lengths 0 and 1, lengths at split boundaries, a window starting
    inside a split, the largest group at h 128 and bs 64, a one-block
    table. A row of length 0 gets the mean of V over its whole table, as
    the plain version and the JAX kernel give it."""
    slots, g, r, h, bs, nb, lengths, window = PAGED_EDGES[edge]
    rng = np.random.default_rng(7)
    case = _paged_edge_case(rng, slots, g, r, h, bs, nb, lengths, dtype, dev)
    got = PA.paged_decode_attention(*case, g, window=window)
    want = PA.paged_decode_attention_reference(*case, g, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, 1e-3)


def test_launch_counters_count_launches(dev):
    q = torch.zeros((1, 64, 2, 64), device=dev)
    before = A.FLASH_FWD.launches
    A.flash_attention(q, q, q)
    assert A.FLASH_FWD.launches == before + 1
    with pytest.raises(ValueError):
        A.flash_attention_with_lse(q.half(), q.half(), q.half())
    assert A.FLASH_FWD.launches == before + 1


BWD_BF16_TOL = 8e-3
BWD_BF16_MEAN_TOL = 1e-5


def _bwd_inputs(rng, b, s, n, g, h, dtype, dev, cfg, dlse, fused=False):
    def randn(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)

    if fused:   # q, k, v and dO as strided views, as the layer makes them
        qkv = randn(b, s, 3, n, h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = randn(b, n, s, h).transpose(1, 2)
    else:
        q, do = randn(b, s, n, h), randn(b, s, n, h)
        k, v = randn(b, s, g, h), randn(b, s, g, h)
    o, lse = A.flash_attention_plain(q, k, v, cfg)
    dl = (torch.tensor(rng.normal(size=(b, n, s)), dtype=torch.float32,
                       device=dev) if dlse else None)
    return q, k, v, do, lse, A.flash_bwd_delta(o, do, dl)


def _rel_errors(got, want):
    """(max, mean) of |got - want| relative to |want|, per output."""
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
    out = []
    for x, y in zip(got, want):
        d, y = (x.float() - y.float()).abs(), y.float().abs()
        out.append(((d.max() / y.max()).item(), (d.mean() / y.mean()).item()))
    return out


def _bwd_errors(q, k, v, do, lse, delta, cfg):
    got = (A.flash_bwd_dq(q, k, v, do, lse, delta, cfg),
           *A.flash_bwd_dkdv(q, k, v, do, lse, delta, cfg))
    want = (A.flash_bwd_dq_plain(q, k, v, do, lse, delta, cfg),
            *A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, cfg))
    return _rel_errors(got, want)


def _assert_bwd_close(errs, dtype):
    tol, mean_tol = ((1e-5, 1e-5) if dtype == torch.float32
                     else (BWD_BF16_TOL, BWD_BF16_MEAN_TOL))
    assert all(e <= tol and m <= mean_tol for e, m in errs), (
        f"(max, mean) relative errors of dq, dk, dv: {errs}")


_BWD_MASKS = {"causal": (True, 0), "window37": (True, 37),
              "noncausal": (False, 0)}
# name: (b, s, n, g, h, causal, window, dlse). The bf16 (wgmma/TMA)
# instances' edges: many tiles queued per CTA, so each warpgroup's ring
# wraps its phase several times (s 1024); one kv head for 8 query heads
# (g 1: dK/dV sums the whole group); windows of 1 (the diagonal only) and
# of one tile; one ragged tile (s 17); batch 1. Under window 1 a row sees
# only itself, so p = 1 and dp = delta up to rounding: without an lse
# cotangent dq and dk are rounding noise, with one ds = p * dlse * scale.
BWD_EDGES = {
    "s1024": (2, 1024, 8, 8, 64, True, 0, False),
    "s1024_h128_gqa_window64": (1, 1024, 8, 2, 128, True, 64, True),
    "g1": (2, 256, 8, 1, 64, True, 0, False),
    "g1_h128_noncausal": (2, 200, 8, 1, 128, False, 0, True),
    "window1": (2, 256, 8, 8, 64, True, 1, True),
    "window1_h128_gqa": (1, 200, 8, 2, 128, True, 1, True),
    "window64": (2, 256, 8, 2, 64, True, 64, True),
    "s17": (2, 17, 4, 4, 64, True, 0, False),
    "s17_h128_g1_noncausal": (1, 17, 4, 1, 128, False, 0, True),
    "batch1": (1, 256, 8, 8, 64, True, 0, False),
    "batch1_h128_window64": (1, 256, 8, 8, 128, True, 64, False),
}
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BWD_CASES = [
    pytest.param(dtype, 2, s, n, g, h, *_BWD_MASKS[mask], dlse,
                 id=f"{dn}-h{h}-{heads}-{mask}-s{s}-"
                    f"{'dlse' if dlse else 'delta'}")
    for dn, dtype in _DTYPES.items()
    for h in (64, 128)
    for heads, (n, g) in (("mha", (8, 8)), ("gqa", (8, 2)))
    for mask in _BWD_MASKS
    for s in (256, 200)
    for dlse in (False, True)
] + [
    pytest.param(dtype, *case, id=f"{dn}-{name}")
    for dn, dtype in _DTYPES.items()
    for name, case in BWD_EDGES.items()
]


@pytest.mark.parametrize("dtype,b,s,n,g,h,causal,window,dlse", BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, dtype, b, s, n, g, h, causal,
                                       window, dlse):
    rng = np.random.default_rng(4)
    cfg = A.FlashConfig(causal=causal, window=window)
    _assert_bwd_close(_bwd_errors(
        *_bwd_inputs(rng, b, s, n, g, h, dtype, dev, cfg, dlse), cfg), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_read_strided_views(dev, dtype):
    rng = np.random.default_rng(5)
    cfg = A.FlashConfig()
    inputs = _bwd_inputs(rng, 2, 192, 4, 4, 64, dtype, dev, cfg, False,
                         fused=True)
    assert not inputs[0].is_contiguous() and not inputs[3].is_contiguous()
    _assert_bwd_close(_bwd_errors(*inputs, cfg), dtype)


def test_flash_bwd_misaligned_bf16_views(dev):
    """The bf16 kernels read q/k/v/dO by TMA: a view whose head stride is
    not a 16-byte multiple raises ValueError before any launch, and the
    autograd backward copies such a dO and launches the kernels."""
    rng = np.random.default_rng(8)
    cfg = A.FlashConfig()
    q, k, v, do, _, _ = _bwd_inputs(rng, 2, 130, 4, 4, 64, torch.bfloat16,
                                    dev, cfg, False)

    def misaligned(x):          # head stride 68 elements: 136 bytes
        pad = torch.zeros(x.shape[:3] + (68,), dtype=x.dtype, device=dev)
        pad[..., :64] = x
        return pad[..., :64]

    bad_do, bad_q = misaligned(do), misaligned(q)
    o, lse = A.flash_attention_with_lse(q, k, v, cfg)
    delta = A.flash_bwd_delta(o, do)
    before = (A.FLASH_BWD_DKDV.launches, A.FLASH_BWD_DQ.launches)
    for args in ((q, k, v, bad_do), (bad_q, k, v, do)):
        with pytest.raises(ValueError, match="TMA"):
            A.flash_bwd_dq(*args, lse, delta, cfg)
        with pytest.raises(ValueError, match="TMA"):
            A.flash_bwd_dkdv(*args, lse, delta, cfg)
    assert (A.FLASH_BWD_DKDV.launches, A.FLASH_BWD_DQ.launches) == before

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(A.flash_attention(*leaves, cfg), leaves,
                              bad_do)
    assert (A.FLASH_BWD_DKDV.launches, A.FLASH_BWD_DQ.launches) == (
        before[0] + 1, before[1] + 1)
    want = (A.flash_bwd_dq_plain(q, k, v, do, lse, delta, cfg),
            *A.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, cfg))
    _assert_bwd_close(_rel_errors(got, want), torch.bfloat16)


def test_flash_autograd_launches_the_backward_kernels(dev):
    """One backward through the op launches each backward kernel once;
    its gradients match autograd through the reference attention."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.normal(size=(2, 130, 4, 64)),
                            dtype=torch.float32, device=dev,
                            requires_grad=True) for _ in range(3))
    w = torch.tensor(rng.normal(size=(2, 130, 4, 64)), dtype=torch.float32,
                     device=dev)
    before = (A.FLASH_BWD_DKDV.launches, A.FLASH_BWD_DQ.launches)
    got = torch.autograd.grad((A.flash_attention(q, k, v) * w).sum(),
                              (q, k, v))
    assert (A.FLASH_BWD_DKDV.launches, A.FLASH_BWD_DQ.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(
        (A.reference_attention(q, k, v) * w).sum(), (q, k, v))
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):     # lse must be f32 [b, n, s]
        A.flash_bwd_dq(q, k, v, w, torch.zeros(2, 4, 130, device=dev).half(),
                       torch.zeros(2, 4, 130, device=dev), A.FlashConfig())
    assert A.FLASH_BWD_DQ.launches == before[1] + 1

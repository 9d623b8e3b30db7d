"""Device and host time of the flash forward, flash backward and paged
decode kernels around the main path's shapes, and host time of the
pre-copy transport. Needs the card, as ``chip_smoke.py`` does:

    python3 -m elastic_tpu_agent_torch.kernel_scan [--out FILE]

Prints one line per reading and, with ``--out``, writes them all as JSON:

- ``floor``: one tiny PyTorch kernel (a 16-element fill), the least a
  queued launch costs on the card;
- ``flash``: the bf16 flash forward and SDPA (the library yardstick) over
  batch, sequence length and causality, device time;
- ``bwd``: the bf16 flash backward kernels (dK/dV and dQ, causal) and
  SDPA's whole backward (dq, dk, dv; the library yardstick) over batch,
  sequence length and head_dim, device time;
- ``ptxas``: what ``-Xptxas -v`` reported for every instance in
  ``csrc/flash_bwd.cu`` (registers, stack frame, spills), from the build
  log beside its library;
- ``paged``: the paged decode at 8 slots x 512 positions x 8 kv heads with
  each split count forced, then through the wrapper (the policy's splits)
  at shorter lengths, device time;
- ``host``: host time per call of the flash forward's C entry (which
  encodes its three TMA maps) against the float32 entry (no maps), of the
  Python wrappers, and of the paged wrapper (calls the host paces, at a
  tiny shape);
- ``transport``: the runner's pre-copy transport on the ``small``
  preset's train state (f32 params, Adam moments, the count; 706 MB): its
  copy to pinned host memory (the first, which allocates the buffer, and
  one that reuses it), then delta rounds that write every block
  and rounds that write none (hashing only), with the block pool at 8
  workers and at 1, in turns (8, 1, 1, 8), host time.

Device times are ``chip_smoke.device_ms``: CUDA events around calls queued
behind a sleep kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def ptxas_lines(log: str) -> list:
    """One record per compiled entry function of a ``-Xptxas -v`` log:
    its (demangled, where c++filt exists) name, registers, stack frame
    and spill bytes."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        out.append(dict(
            name=name, registers=int(regs.group(1)) if regs else None,
            stack_frame=int(frame.group(1)) if frame else None,
            spill_stores=int(frame.group(2)) if frame else None,
            spill_loads=int(frame.group(3)) if frame else None))
    if shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["name"] for r in out),
            capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(out, names):
            r["name"] = n or r["name"]
    return out


def transport(torch, C, dev) -> dict:
    import tempfile

    from elastic_tpu_agent_torch.workloads import checkpointing as CK
    from elastic_tpu_agent_torch.workloads import transformer as TR

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    cfg = TR.ModelConfig(**C.SMALL, max_seq=256, dtype=torch.bfloat16)
    state = TR.make_train_step(cfg, device=dev)[1](
        torch.Generator().manual_seed(0))
    # the first copy allocates the pinned buffer; a dropped buffer goes
    # back to the cache, so the second copy reuses it
    copy_first_ms = ms(lambda: CK.tree_to_bytes(state))
    rec = dict(copy_first_ms=copy_first_ms,
               copy_ms=ms(lambda: CK.tree_to_bytes(state)), rounds=[])
    payload = CK.tree_to_bytes(state)
    rec["payload_bytes"] = len(payload)
    default = CK.BLOCK_WORKERS
    try:
        for workers in (8, 1, 1, 8):
            CK.BLOCK_WORKERS = workers
            with tempfile.TemporaryDirectory() as d:
                delta = CK.DeltaCheckpointer(d)
                rec["rounds"].append(dict(
                    workers=workers,
                    write_all_ms=ms(lambda: delta.save(0, payload)),
                    hash_only_ms=ms(lambda: delta.save(1, payload))))
    finally:
        CK.BLOCK_WORKERS = default
    print(f"transport: {rec['payload_bytes']} bytes, copy to the host "
          f"{rec['copy_ms']:.1f} ms ({rec['copy_first_ms']:.1f} the first "
          "time); " + "; ".join(
              f"{r['workers']} worker(s): every block hashed and written "
              f"{r['write_all_ms']:.1f} ms, hashed only "
              f"{r['hash_only_ms']:.1f} ms" for r in rec["rounds"]))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="JSON file for the readings")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_scan: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from elastic_tpu_agent_torch import kernels
    from elastic_tpu_agent_torch.workloads import attention as A
    from elastic_tpu_agent_torch.workloads import paged_attention as PA

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(C.SEED)
    out = {"floor": {}, "flash": [], "bwd": [], "ptxas": [], "paged": [],
           "host": {}}
    kernels.build_all()
    log = kernels._library_path(kernels.CSRC / "flash_bwd.cu")
    out["ptxas"] = ptxas_lines(log.with_suffix(".log").read_text())
    for r in out["ptxas"]:
        print(f"ptxas {r['name']}: {r['registers']} registers, stack frame "
              f"{r['stack_frame']}, spill stores {r['spill_stores']}, "
              f"loads {r['spill_loads']}")

    def us(fn):
        return C.device_ms(torch, fn)[0] * 1e3

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    x = torch.zeros(16, device=dev)
    out["floor"]["fill_us"] = us(x.zero_)
    print(f"floor: 16-element fill {out['floor']['fill_us']:.2f} us")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, causal in ((8, 64, True), (8, 256, True), (8, 256, False),
                         (1, 256, True), (8, 1024, True)):
        q, k, v = (C.randn(torch, rng, (b, s, 8, 64), torch.bfloat16, dev)
                   for _ in range(3))
        fc = A.FlashConfig(causal=causal)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rec = dict(b=b, s=s, causal=causal,
                   kernel_us=us(lambda: A.flash_attention_with_lse(q, k, v,
                                                                   fc)),
                   sdpa_us=us(lambda: sdpa(qt, kt, vt, is_causal=causal)))
        out["flash"].append(rec)
        print(f"flash [{b},{s},8,64] causal {causal}: kernel "
              f"{rec['kernel_us']:.2f} us, SDPA {rec['sdpa_us']:.2f} us")

    for b, s, h in ((8, 64, 64), (1, 256, 64), (8, 256, 64), (8, 1024, 64),
                    (8, 256, 128)):
        fc = A.FlashConfig()
        inputs = C._bwd_inputs(torch, A, rng, dev, (b, s, 8, 8, h),
                               torch.bfloat16, fc, False)
        q, k, v, do = inputs[:4]
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        o_sdpa = sdpa(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        rec = dict(
            b=b, s=s, h=h,
            dkdv_us=us(lambda: A.flash_bwd_dkdv(*inputs, fc)),
            dq_us=us(lambda: A.flash_bwd_dq(*inputs, fc)),
            sdpa_backward_us=us(lambda: torch.autograd.grad(
                o_sdpa, (qt, kt, vt), dot, retain_graph=True)))
        out["bwd"].append(rec)
        print(f"flash_bwd [{b},{s},8,{h}] bf16 causal: dK/dV "
              f"{rec['dkdv_us']:.2f} us, dQ {rec['dq_us']:.2f} us, SDPA's "
              f"whole backward {rec['sdpa_backward_us']:.2f} us")

    q, pk, pv, table, lengths = C._paged_inputs(torch, rng, dev,
                                                torch.bfloat16, 8, 1, True)
    slots, n, h = q.shape
    nb, bs = table.shape[1], pk.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    counters = PA._counters(dev, stream, slots * 8)
    for splits in (1, 2, 4, 8, 16):
        o = torch.empty_like(q)
        part = torch.empty(slots * n * splits * (h + 2), dtype=torch.float32,
                           device=dev)

        def call():
            PA.PAGED_DECODE(
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), o.data_ptr(), part.data_ptr(),
                counters.data_ptr(), 1, slots, n, 8, h, nb, bs, q.stride(0),
                q.stride(1), pk.stride(0), pk.stride(1), pk.stride(2),
                table.stride(0), 1 / math.sqrt(h), 0, splits, stream)
        rec = dict(splits=splits, length=nb * bs, us=us(call))
        out["paged"].append(rec)
        print(f"paged 512 positions, {splits} splits: {rec['us']:.2f} us")
    for length in (16, 128):
        ln = torch.full((slots,), length, dtype=torch.int32, device=dev)
        rec = dict(splits=PA.paged_splits(slots, 8, nb), length=length,
                   us=us(lambda: PA.paged_decode_attention(
                       q, pk, pv, table, ln, 8)))
        out["paged"].append(rec)
        print(f"paged {length} positions (wrapper): {rec['us']:.2f} us")

    hq = out["host"]
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q1, k1, v1 = (C.randn(torch, rng, (1, 64, 1, 64), dt, dev)
                      for _ in range(3))
        o1 = torch.empty_like(q1)
        lse = torch.empty((1, 1, 64), device=dev)
        cargs = (q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), o1.data_ptr(),
                 lse.data_ptr(), A.KERNEL_DTYPES[dt], 1, 64, 1, 1, 64,
                 *A._strides(q1, k1, v1), 0.125, 1, 0, stream)
        fc = A.FlashConfig()
        hq[f"flash_c_entry_{name}_us"] = host_us(lambda: A.FLASH_FWD(*cargs))
        hq[f"flash_wrapper_{name}_us"] = host_us(
            lambda: A.flash_attention_with_lse(q1, k1, v1, fc))
    hq["paged_wrapper_us"] = host_us(
        lambda: PA.paged_decode_attention(q, pk, pv, table, lengths, 8))
    print("host per call: " + ", ".join(f"{k} {v:.1f}" for k, v in hq.items()))
    out["transport"] = transport(torch, C, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

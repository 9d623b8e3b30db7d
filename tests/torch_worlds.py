"""Spawned torch.distributed worlds for the port's multi-device tests.

The JAX side of a multi-device parity test runs in the test process on
the 8 host devices ``conftest.py`` gives; the port runs SPMD, one process
per rank, so its side runs here: ``run_world`` spawns ``world`` ranks
joined in a gloo process group on a free local port, runs one ``legs``
function (defined in this module, so that a spawned child imports it
without JAX) in every rank, and returns each rank's result. Every child
is joined against one deadline and killed after it: a hung world fails
the test instead of waiting.

Each leg function takes (rank, world, spec) and returns plain data
(numpy arrays, floats, lists, dicts).
"""

from __future__ import annotations

import os
import signal
import socket
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np

WORLD_TIMEOUT_S = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, out_dir, spec, init):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"{rank}.pt")
    try:
        if not init:
            # the leg joins (and leaves) the group itself, at this port
            os.environ["ELASTIC_TPU_COORD_PORT"] = str(port)
            result = fn(rank, world, spec)
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                world_size=world, timeout=timedelta(seconds=WORLD_TIMEOUT_S),
            )
            try:
                result = fn(rank, world, spec)
            finally:
                dist.destroy_process_group()
        torch.save({"ok": result}, path)
    except BaseException:  # noqa: BLE001 - reported to the test process
        torch.save({"error": traceback.format_exc()}, path)
        raise


def run_world(fn, world: int, spec, timeout: float = WORLD_TIMEOUT_S,
              init: bool = True):
    """[fn(rank, world, spec) for every rank], each run in its own spawned
    process of a gloo world. Raises with the child's traceback if a rank
    failed, and kills every child still alive at the deadline. With
    ``init`` False the children start without a group and the legs join
    it themselves at ``ELASTIC_TPU_COORD_PORT`` (a free local port)."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="torch_world_") as out:
        procs = [ctx.Process(target=_child,
                             args=(fn, r, world, port, out, spec, init))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(out, f"{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(
                path) else {"error": f"rank {r} exited "
                            f"{procs[r].exitcode} without a result"}
            if "error" in got:
                errors.append(f"rank {r}: {got['error']}")
            results.append(got.get("ok"))
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


# -- legs ---------------------------------------------------------------------


def _numpy_tree(tree):
    from elastic_tpu_agent_torch.workloads.weights import params_to_jax

    return params_to_jax(tree)


def train_legs(rank, world, spec):
    """Sharded train steps: for each leg, ``steps`` steps of the port's
    mesh step from the bridged JAX tree; every rank returns its losses
    and the gathered params (and EMA), so that the test sees that the
    ranks agree."""
    import torch

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import transformer as tt
    from elastic_tpu_agent_torch.workloads.weights import params_from_jax

    out = {}
    for leg in spec["legs"]:
        if leg.get("checks"):
            out[leg["name"]] = mesh_checks(world)
            continue
        dp, sp, tp, *ep = leg["mesh"]
        mesh = parallel.make_mesh(world, dp=dp, sp=sp, tp=tp,
                                  ep=ep[0] if ep else 1, device_type="cpu")
        cfg = tt.ModelConfig(**leg["cfg"], dtype=torch.float32)
        full = params_from_jax(leg["tree"], cfg, device="cpu",
                               dtype=torch.float32)
        params = parallel.shard_params(full, mesh, cfg)
        probe = moe_probe(mesh, cfg, params, leg) if leg.get("probe") else {}
        if leg.get("eval"):
            ev = tt.make_eval_fn(cfg, device="cpu", mesh=mesh)
            out[leg["name"]] = {"eval": float(ev(params, leg["tokens"]))}
            continue
        step, _, opt = tt.make_train_step(
            cfg, learning_rate=spec["lr"], device="cpu", mesh=mesh,
            **leg.get("opts", {}))
        state = opt.init(params)
        shapes = {k: {} for k in state if k != "count"}
        for k in shapes:
            tt._tree_map(lambda path, x, k=k: shapes[k].__setitem__(
                "/".join(map(str, path)), tuple(x.shape)), state[k])
        losses = [float(step(params, state, leg["tokens"])[2])
                  for _ in range(spec["steps"])]
        res = {"losses": losses, "state_shapes": shapes,
               "params": _numpy_tree(parallel.gather_params(params, mesh,
                                                            cfg)), **probe}
        if "ema" in state:
            res["ema"] = _numpy_tree(parallel.gather_params(
                zero1_gather(state["ema"], params, opt), mesh, cfg))
        out[leg["name"]] = res
    return out


def moe_probe(mesh, cfg, params, leg):
    """The sharded forward at the leg's first params, on its tokens'
    inputs: the aux loss, and for each MoE layer the global [B, S] of its
    input rows, expert ids and kept flags (gathered over sp and dp), with
    the kept flags that routing this rank's tokens alone would give."""
    import torch

    from elastic_tpu_agent_torch.workloads import moe as tm
    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import transformer as tt

    view = parallel.local_view(mesh)
    tokens = torch.as_tensor(leg["tokens"]).long()
    inputs, _, off, _ = tt._local_chunk(tokens, view)
    calls, real = [], tm.route

    def logged(xt, wg, factor, **kw):
        res = real(xt, wg, factor, **kw)
        calls.append((xt, wg, factor, res))
        return res

    tm.route = logged
    try:
        with torch.no_grad():
            _, aux = tt._forward(params, inputs, cfg, torch.device("cpu"),
                                 view, off)
    finally:
        tm.route = real

    def whole(x):          # [b * s_loc, ...] -> the global [B, S, ...]
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        x = x.reshape(inputs.shape[0], inputs.shape[1], *x.shape[1:])
        return parallel._gather_axis(
            parallel._gather_axis(x, 1, view.sp), 0, view.dp).numpy()

    layers = []
    with torch.no_grad():
        for xt, wg, factor, (_, expert, _, kept, _) in calls:
            alone = real(xt, wg, factor)[3]
            layers.append(dict(h=whole(xt), expert=whole(expert),
                               kept=whole(kept), kept_alone=whole(alone)))
    return {"aux": float(aux), "routes": layers}


def mesh_checks(world):
    """make_mesh's names and default shape, and the messages of its
    refusals."""
    from elastic_tpu_agent_torch.workloads import parallel

    mesh = parallel.make_mesh(device_type="cpu")
    out = {"dims": list(mesh.mesh_dim_names), "shape": list(mesh.shape)}
    for key, kw in (("cuda_on_gloo", {}), ("wrong_n", {"n_devices": 2})):
        try:
            parallel.make_mesh(device_type="cuda" if not kw else "cpu", **kw)
            out[key] = "no error"
        except ValueError as e:
            out[key] = str(e)
    return out


def zero1_gather(tree, params, opt):
    """A ZeRO-1 state tree (sliced over dp) put back whole, like the
    params it follows."""
    from elastic_tpu_agent_torch.workloads import transformer as tt

    if opt.zero1 is None:
        return tree
    axes = opt.zero1.axes(params)
    fulls = [p.detach().clone().float() for p in tt._leaves(params)]
    opt.zero1.gather_(fulls, tt._leaves(tree), axes)
    return tt._like(params, fulls)


def ring_legs(rank, world, spec):
    """Ring attention over the sp group of a (1, world, 1) mesh: each rank
    runs its chunk of every leg's q/k/v and returns its output chunk and
    its chunks' gradients of sum(o * w); and the dispatch of
    ``_attention_core`` under "auto"."""
    import torch

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import ring_attention as ra
    from elastic_tpu_agent_torch.workloads import transformer as tt

    mesh = parallel.make_mesh(world, dp=1, sp=world, tp=1, device_type="cpu")

    def chunk(a):
        s = a.shape[1] // world
        return torch.from_numpy(np.ascontiguousarray(
            a[:, rank * s:(rank + 1) * s]))

    out = {}
    for leg in spec["legs"]:
        q, k, v, w = (chunk(leg[x]).requires_grad_(x != "w")
                      for x in ("q", "k", "v", "w"))
        o = ra.ring_attention_sharded(q, k, v, mesh, causal=leg["causal"])
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        out[leg["name"]] = [o.detach().numpy()] + [g.numpy() for g in grads]
    # "auto" under sp > 1 runs the ring
    calls = []
    ring = tt.ring_attention
    tt.ring_attention = lambda *a, **kw: calls.append(1) or ring(*a, **kw)
    try:
        leg = spec["legs"][0]
        cfg = tt.ModelConfig(vocab=8, d_model=16, n_heads=1, n_layers=1,
                             d_ff=8, dtype=torch.float32)
        q, k, v = (chunk(leg[x]) for x in ("q", "k", "v"))
        auto = tt._attention_core(q, k, v, cfg, parallel.local_view(mesh))
    finally:
        tt.ring_attention = ring
    out["auto"] = {"calls": len(calls), "o": auto.numpy()}
    return out


def pipeline_legs(rank, world, spec):
    """Pipelines over a ("pp", "dp") mesh of the world, one leg at a time:
    ``apply`` (pipeline_apply of the toy block stack and the gradients of
    sum(out * w)), ``toy_step`` (make_pipeline_train_step), ``step`` (the
    pipelined transformer's train step) and ``grads_1f1b``
    (pipeline_1f1b_grads and the embedding's gradients). Every rank
    returns what it holds, gathered over pp (stages) and dp (rows)."""
    import torch

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import pipeline as pl
    from elastic_tpu_agent_torch.workloads import transformer as tt
    from elastic_tpu_agent_torch.workloads import transformer_pipeline as tp
    from elastic_tpu_agent_torch.workloads.weights import (
        pipeline_params_from_jax,
        stage_params_from_jax,
    )

    out = {}
    for leg in spec["legs"]:
        pp, dp = leg["mesh"]
        mesh = pl.make_pipeline_mesh(pp, dp, device_type="cpu")
        pipe = pl.as_pipe(mesh)

        def rows_whole(x, axis=1):
            return parallel._gather_axis(x, axis, pipe.dp).numpy()

        if leg["kind"] in ("apply", "toy_step"):
            full = stage_params_from_jax(leg["tree"], device="cpu")
        else:
            cfg = tt.ModelConfig(**leg["cfg"], dtype=torch.float32)
            full = pipeline_params_from_jax(leg["tree"], cfg, pp, device="cpu")
        if leg["kind"] == "apply":
            params = pl.shard_stages(full, mesh)
            live = tt._tree_map(lambda path, a: a.requires_grad_(), params)
            x = pl.dp_rows(torch.from_numpy(leg["x"]), pipe).clone()
            x.requires_grad_()
            w = pl.dp_rows(torch.from_numpy(leg["w"]), pipe)
            with torch.enable_grad():
                y = pl.pipeline_apply(mesh, pl.stage_block, live, x)
                torch.autograd.backward((y * w).sum())
            grads = [a.grad for a in tt._leaves(live)]
            parallel.all_reduce_(grads, (pipe.dp,))
            # only stage 0 reads x: its gradient, summed over pp
            dx = x.grad if x.grad is not None else torch.zeros_like(x)
            parallel.all_reduce_([dx], (pipe.group,))
            out[leg["name"]] = dict(
                y=rows_whole(y.detach()), dx=rows_whole(dx),
                grads=_numpy_tree(pl.gather_stages(
                    tt._like(params, grads), mesh)))
        elif leg["kind"] == "toy_step":
            step, _ = pl.make_pipeline_train_step(
                mesh, leg["d"], leg["ff"], device="cpu")
            params = pl.shard_stages(full, mesh)
            state = tt.AdamW(1e-2, weight_decay=0.0).init(params)
            out[leg["name"]] = [float(step(params, state, leg["x"],
                                           leg["y"])[2])
                                for _ in range(spec["toy_steps"])]
        elif leg["kind"] == "step":
            step, _ = tp.make_pipeline_transformer_step(
                cfg, mesh, n_micro=leg["tokens"].shape[0],
                schedule=leg["schedule"], device="cpu")
            params = dict(full, stages=pl.shard_stages(full["stages"], mesh))
            state = tt.AdamW(1e-3).init(params)
            losses = [float(step(params, state, leg["tokens"])[2])
                      for _ in range(spec["steps"])]
            params["stages"] = pl.gather_stages(params["stages"], mesh)
            out[leg["name"]] = dict(losses=losses,
                                    params=_numpy_tree(params))
        else:                                           # grads_1f1b
            toks = pl.dp_rows(torch.from_numpy(leg["tokens"]).long(), pipe)
            embed = {k: full[k].requires_grad_() for k in ("embed",
                                                            "pos_embed")
                     if k in full}
            with torch.enable_grad():
                xs = tp._embed_fn(embed, toks[:, :, :-1], cfg)
            g_stage, g_head, dxs, loss = tp.pipeline_1f1b_grads(
                mesh, cfg, pl.shard_stages(full["stages"], mesh),
                tp._split_head(full), xs, toks[:, :, 1:])
            g_embed = dict(zip(embed, torch.autograd.grad(
                xs, list(embed.values()), dxs)))
            parallel.all_reduce_(list(g_embed.values()), (pipe.dp,))
            out[leg["name"]] = dict(
                loss=float(loss), head=_numpy_tree(g_head),
                embed=_numpy_tree(g_embed),
                stages=_numpy_tree(pl.gather_stages(g_stage, mesh)))
    return out


def decode_legs(rank, world, spec):
    """Sharded decode over a (dp, 1, tp) mesh of the world: for each leg,
    ``generate(..., mesh=)`` on this rank's ``decode_shardings`` slice of
    the bridged tree (float or int8); every rank returns the whole
    output."""
    import torch

    import importlib

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import transformer as tt
    from elastic_tpu_agent_torch.workloads.weights import params_from_jax

    tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

    out = {}
    for leg in spec["legs"]:
        dp, tp = leg["mesh"]
        mesh = parallel.make_mesh(world, dp=dp, sp=1, tp=tp,
                                  device_type="cpu")
        cfg = tt.ModelConfig(**leg["cfg"], dtype=torch.float32)
        full = params_from_jax(leg["tree"], cfg, device="cpu",
                               dtype=torch.float32)
        specs, _ = tg.decode_shardings(mesh, cfg, full)
        params = parallel.shard_params(full, mesh, cfg, specs)
        gen = torch.Generator().manual_seed(leg.get("seed", 0))
        toks = tg.generate(params, leg["prompt"], cfg, leg["new"],
                           generator=gen, device="cpu", mesh=mesh,
                           **leg.get("sampling", {}))
        out[leg["name"]] = toks.numpy()
    return out


def serve_script(eng, admissions, kw=()):
    """The TP serving tests' script (JAX ``tests/test_tp_serving.py``'s
    ``_run``): admit, 3 steps, a second admission, 4 steps; returns both
    streams and the pool occupancy after the admission and every step.
    ``kw`` gives each admission's sampling arguments."""
    kw = list(kw) or [{}, {}]
    occupancy = []
    ra = eng.admit(list(admissions[0]), **kw[0])
    occupancy.append(eng.used_blocks)
    for _ in range(3):
        eng.step()
        occupancy.append(eng.used_blocks)
    rb = eng.admit(list(admissions[1]), **kw[1])
    for _ in range(4):
        eng.step()
        occupancy.append(eng.used_blocks)
    return [eng.release(ra), eng.release(rb), occupancy]


def churn_script(eng, prompts):
    """One slot, requests one after another: each stream and the pool
    empty after each release."""
    out = []
    for prompt in prompts:
        rid = eng.admit(list(prompt))
        for _ in range(4):
            eng.step()
        out.append([eng.release(rid), eng.used_blocks])
    return out


def prefix_script(eng, system, tails):
    """The prefix cache under serving: admissions sharing ``system``
    (automatic cache hits), ``register_prefix`` + ``admit(prefix=)``, and
    a chunked ``enqueue``; streams, occupancy after every step, and the
    cache's hit count."""
    out, occupancy = [], []

    def run(rid, steps=3):
        for _ in range(steps):
            eng.step()
            occupancy.append(eng.used_blocks)
        out.append(eng.release(rid))

    for tail in tails:
        run(eng.admit(list(system) + list(tail)))
    pid = eng.register_prefix(list(system))
    run(eng.admit(list(tails[0]), prefix=pid))
    eng.release_prefix(pid)
    run(eng.enqueue(list(system) + [8, 8, 8]), steps=6)
    return [out, occupancy, eng.stats()["prefix_cache"]["hits"]]


def _spec_lists(tree):
    """Split specs as plain lists (picklable, comparable)."""
    if isinstance(tree, dict):
        return {k: _spec_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_lists(v) for v in tree]
    return list(tree)


def tp_serving_legs(rank, world, spec):
    """The tensor-parallel ServingEngine over ("dp", "mp") meshes of the
    world, one leg at a time, each beside the single-device engine in the
    same rank: the scripts above, sampled streams, the partitioner's specs
    and pool, kv_int8's first-step logits, the refusals' messages and the
    mesh's shapes."""
    import torch

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import partitioner as tpart
    from elastic_tpu_agent_torch.workloads import quantize as tq
    from elastic_tpu_agent_torch.workloads import serving as ts
    from elastic_tpu_agent_torch.workloads import transformer as tt
    from elastic_tpu_agent_torch.workloads.weights import params_from_jax

    meshes = {}

    def mesh_of(mp):
        if mp not in meshes:
            meshes[mp] = tpart.make_serving_mesh(mp=mp, device_type="cpu")
        return meshes[mp]

    def refusal(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return "no error"

    out = {}
    for leg in spec["legs"]:
        cfg = tt.ModelConfig(**leg["cfg"], dtype=torch.float32)
        params = params_from_jax(leg["tree"], cfg, device="cpu",
                                 dtype=torch.float32)
        kw = dict(leg.get("engine", {}), device="cpu")
        kind = leg["kind"]

        def engines(mp):
            return (ts.ServingEngine(params, cfg, **kw, mesh=mesh_of(mp)),
                    ts.ServingEngine(params, cfg, **kw))

        res = {}
        if kind in ("serve", "sampled"):
            for mp in leg["mps"]:
                tp_eng, one = engines(mp)
                res[mp] = [serve_script(e, leg["admissions"],
                                        leg.get("sampling", ()))
                           for e in (tp_eng, one)]
        elif kind == "churn":
            for mp in leg["mps"]:
                res[mp] = [churn_script(e, leg["prompts"])
                           for e in engines(mp)]
        elif kind == "prefix":
            for mp in leg["mps"]:
                res[mp] = [prefix_script(e, leg["system"], leg["tails"])
                           for e in engines(mp)]
        elif kind == "layout":
            qparams = tq.quantize_params(params)
            for mp in leg["mps"]:
                part = tpart.ServingPartitioner(mesh_of(mp), cfg)
                eng = ts.ServingEngine(params, cfg, **kw, mesh=mesh_of(mp))
                full = ts._pool_empty(
                    (cfg.n_layers, 3, 4, cfg.kv_heads, cfg.head_dim),
                    torch.float32, "cpu", kv_int8=True)
                full["q"].copy_(torch.arange(full["q"].numel()).reshape(
                    full["q"].shape) % 100)
                placed = part.place_pool(full)
                res[mp] = dict(
                    specs=_spec_lists(part.param_shardings(params)),
                    int8_specs=_spec_lists(part.param_shardings(qparams)),
                    pool_spec=list(part.pool_sharding()),
                    pool_shape=list(eng._pool_k.shape),
                    wo_shape=list(eng.params["layers"][0]["wo"].shape),
                    placed_q=placed["q"].numpy(),
                    placed_s_shape=list(placed["s"].shape),
                )
        elif kind == "int8":
            for mp in leg["mps"]:
                logits, streams, pools = [], [], []
                for e in engines(mp):
                    seen, pick = [], e._pick
                    e._pick = (lambda lg, *a, seen=seen, pick=pick:
                               seen.append(lg.clone()) or pick(lg, *a))
                    rid = e.admit(list(leg["admissions"][0]))
                    for _ in range(4):
                        e.step()
                    streams.append(e.release(rid))
                    logits.append(seen[0].numpy())
                    pools.append([list(e._pool_k["q"].shape),
                                  list(e._pool_k["s"].shape),
                                  str(e._pool_k["q"].dtype)])
                res[mp] = dict(logits=logits, streams=streams, pools=pools)
        elif kind == "refusals":
            dense = dict(kw, mesh=mesh_of(leg["mps"][0]))
            gqa = tt.ModelConfig(**dict(leg["cfg"], n_kv_heads=2),
                                 dtype=torch.float32)
            moe = tt.ModelConfig(**dict(leg["cfg"], moe_experts=2),
                                 dtype=torch.float32)
            pool = ts.SharedKVPool(cfg, block_size=4, pool_blocks=40,
                                   device="cpu")
            res = dict(
                kv_heads=refusal(lambda: ts.ServingEngine(
                    params_from_jax(leg["gqa_tree"], gqa, device="cpu",
                                    dtype=torch.float32), gqa, **dense)),
                paged_kernel=refusal(lambda: ts.ServingEngine(
                    params, cfg, **dense, paged_kernel=True)),
                draft=refusal(lambda: ts.ServingEngine(
                    params, cfg, **dense, draft_params=params,
                    draft_cfg=cfg)),
                pool=refusal(lambda: ts.ServingEngine(
                    params, cfg, **dict(kw, block_size=4), pool=pool,
                    mesh=mesh_of(leg["mps"][0]))),
                no_mp=refusal(lambda: tpart.ServingPartitioner(
                    parallel.make_mesh(world, dp=world, sp=1, tp=1,
                                       device_type="cpu"), cfg)),
                moe=refusal(lambda: tpart.ServingPartitioner(
                    mesh_of(leg["mps"][0]), moe)),
            )
        elif kind == "mesh":
            def shape(**kw):
                m = tpart.make_serving_mesh(device_type="cpu", **kw)
                return [list(m.mesh_dim_names), list(m.shape)]

            res = dict(mp2=shape(mp=2), default=shape(),
                       bad_mp=refusal(lambda: shape(mp=3)),
                       bad_n=refusal(lambda: shape(mp=2, n_devices=8)))
        out[leg["name"]] = res
    return out


RUNNER_ENV = ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR",
              "ELASTIC_TPU_HBM_FRACTION",
              "ELASTIC_TPU_TRACE_ID", "ELASTIC_TPU_FLIGHT_RECORDER",
              "ELASTIC_TPU_RESTORE_DIR", "ELASTIC_TPU_RESTORE_STEP")


def runner_legs(rank, world, spec):
    """``runner.main(argv, device="cpu")`` through the runner's own join:
    first as one host of ``world`` processes (the launcher's LOCAL_RANK
    and LOCAL_WORLD_SIZE), each leg of ``spec["legs"]`` in turn; then
    ranks 0 and 1 as a two-host slice (``TPU_WORKER_HOSTNAMES``
    localhost,localhost, ``TPU_WORKER_ID`` the rank) for
    ``spec["slice_legs"]``. Test-only patches: the presets compute in f32,
    the train steps start from the JAX runner's init trees (bridged and
    cut for the mesh), decode mode from its params and prompt. A leg is
    (name, argv) or (name, argv, options): ``env``, set for that leg alone
    (an alloc dir with a lifecycle stamp), and ``sigterm_rank``, a rank
    that sends itself SIGTERM inside its first whole-tree gather (a
    pre-copy round). Every rank returns every report with whether its rank
    printed it."""
    import torch
    import torch.distributed as dist

    from elastic_tpu_agent_torch.workloads import parallel
    from elastic_tpu_agent_torch.workloads import pipeline as pl
    from elastic_tpu_agent_torch.workloads import runner as tr
    from elastic_tpu_agent_torch.workloads import transformer as tt
    from elastic_tpu_agent_torch.workloads import transformer_pipeline as ttp
    from elastic_tpu_agent_torch.workloads.weights import (
        params_from_jax,
        pipeline_params_from_jax,
    )

    for k in RUNNER_ENV:
        os.environ.pop(k, None)
    os.environ.update(
        ELASTIC_TPU_ENV_FILE=os.path.join(spec["dir"], "no-env-file"),
        ELASTIC_TPU_RESTORE_WAIT_S="0", TPU_WORKER_HOSTNAMES="localhost",
        TPU_WORKER_ID="0", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
    )
    for name in tr.PRESETS:
        tr.PRESETS[name] = dict(tr.PRESETS[name], dtype=torch.float32)

    dense_step = tt.make_train_step
    pipe_step = ttp.make_pipeline_transformer_step

    def from_jax(cfg, **kw):
        step, _, opt = dense_step(cfg, **kw)

        def init_all(generator):
            full = params_from_jax(spec["tree"], cfg, device="cpu",
                                   dtype=torch.float32)
            mesh = kw.get("mesh")
            params = (full if mesh is None
                      else parallel.shard_params(full, mesh, cfg))
            return params, opt.init(params)

        return step, init_all, opt

    def pipe_from_jax(cfg, mesh, **kw):
        step, _ = pipe_step(cfg, mesh, **kw)

        def init_all(generator):
            full = pipeline_params_from_jax(spec["pipe_tree"], cfg,
                                            pl.as_pipe(mesh).size,
                                            device="cpu")
            params = dict(full, stages=pl.shard_stages(full["stages"], mesh))
            return params, tt.AdamW(kw["learning_rate"]).init(params)

        return step, init_all

    tt.make_train_step = from_jax
    ttp.make_pipeline_transformer_step = pipe_from_jax
    tt.init_params = lambda cfg, generator, device, dtype=None: (
        params_from_jax(spec["tree"], cfg, device=device, dtype=dtype))
    tr.decode_prompt = lambda cfg, b, p: spec["prompt"]
    reports = []
    tr._emit = lambda report, root: reports.append(dict(report, root=root))

    gather = tr._Shards.full

    def run(name, argv, options=None):
        options = options or {}
        env = options.get("env", {})
        os.environ.update(env)
        if options.get("sigterm_rank") == rank:
            def full(self, *trees):
                tr._Shards.full = gather
                os.kill(os.getpid(), signal.SIGTERM)
                return gather(self, *trees)

            tr._Shards.full = full
        reports.clear()
        try:
            assert tr.main(argv.split(), device="cpu") == 0
        finally:
            tr._Shards.full = gather
            for k in env:
                os.environ.pop(k)
        return reports[-1]

    out = {leg[0]: run(*leg) for leg in spec["legs"]}
    # a fresh port for the two-host slice, from rank 0
    port = [free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    dist.destroy_process_group()
    if rank < 2:
        os.environ.update(
            TPU_WORKER_HOSTNAMES="localhost,localhost",
            TPU_WORKER_ID=str(rank),
            LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
            ELASTIC_TPU_COORD_PORT=str(port[0]),
        )
        try:
            out.update({leg[0]: run(*leg) for leg in spec["slice_legs"]})
        finally:
            dist.destroy_process_group()
    return out

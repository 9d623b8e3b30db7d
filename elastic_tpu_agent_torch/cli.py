"""The port's node agent entry point.

The counterpart of ``elastic_tpu_agent/cli.py``'s agent process: flags ->
``NodeManager`` -> run in a thread -> stop on SIGTERM/SIGINT/SIGQUIT, with
a SIGUSR1 stack dump. The flags are the agent's for the ported
subsystems, with the port's defaults (operator ``nvidia``; the device
plugins advertise ``elasticgpu.io/gpu-core`` and ``gpu-memory``). A node
needs grpcio and protobuf for the kubelet's APIs.

Usage:
    python3 -m elastic_tpu_agent_torch.cli --node-name $NODE_NAME \\
        --db-file /host/var/lib/elastic-tpu/meta.db --operator nvidia \\
        --metrics-port 9478

    # a pod's lifecycle history from the db, live agent or dead
    python3 -m elastic_tpu_agent_torch.cli node-doctor timeline \\
        --db-file /host/var/lib/elastic-tpu/meta.db --pod default/train
    # its goodput ledger: each second of its life and what it went to
    python3 -m elastic_tpu_agent_torch.cli node-doctor goodput \\
        --db-file /host/var/lib/elastic-tpu/meta.db --pod default/train
    # the running agent's hottest stacks (needs --profile-hz > 0)
    python3 -m elastic_tpu_agent_torch.cli node-doctor profile \\
        --agent-url http://127.0.0.1:9478
    # the diagnostics bundle (devices, health, allocations, the sampler's
    # windows, the timeline, live traces), and its schema check
    python3 -m elastic_tpu_agent_torch.cli node-doctor \\
        --agent-url http://127.0.0.1:9478 > bundle.json
    python3 -m elastic_tpu_agent_torch.cli node-doctor --validate bundle.json

``--metrics-port`` serves ``/metrics``, ``/healthz`` and the loopback-only
``/debug/*`` routes (metrics.py); 0 turns the endpoint off, and then
nothing imports prometheus_client. ``--nri-socket`` registers the agent
as containerd's NRI plugin (nri/plugin.py): it injects at CreateContainer,
with ``--nri-driver-lib`` mounts of host driver libraries, and with
``--nri-evict-on-chip-failure`` evicts the containers of a card that
goes unhealthy. ``--sampler-period``/``--no-sampler`` set the
utilization sampler, ``--drain-deadline``, ``--drain-period``,
``--preemption-notice`` and ``--maintenance-poll-ttl`` the drain, and
``--migration-period``/``--no-migration`` the migration coordinator,
``--repartition-period``, ``--no-repartition`` and ``--qos-evict-after``
live re-partitioning, ``--goodput-period`` the goodput ledger, and
``--slice-membership-ttl`` the slice registry's membership snapshot.

    # the perf-regression gate over BENCH_r*.json rounds (bench_history.py)
    python3 -m elastic_tpu_agent_torch.cli perf-gate --root . --self-test
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import sys
import threading
import time

from .common import install_dump_signal, wait_for_exit_signal
from .manager import ManagerOptions, NodeManager


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="elastic-gpu-agent")
    p.add_argument("--node-name", default="", help="k8s node this agent runs on")
    p.add_argument(
        "--db-file",
        default="/host/var/lib/elastic-tpu/meta.db",
        help="checkpoint db path (hostPath-mounted to survive restarts)",
    )
    p.add_argument("--kubeconf", default="",
                   help="kubeconfig path (default: in-cluster)")
    p.add_argument("--plugin", default="gpushare", choices=("gpushare",),
                   help="plugin kind (gpushare: gpu-core and gpu-memory)")
    p.add_argument(
        "--operator",
        default="nvidia",
        help="device operator: nvidia | stub | stub:<cards> | exclusive | "
             "exclusive:<inner> (whole cards, no virtual links)",
    )
    p.add_argument("--dev-root", default="/host/dev", help="host /dev mount")
    p.add_argument(
        "--device-plugin-dir",
        default="/var/lib/kubelet/device-plugins",
        help="kubelet device-plugin socket dir",
    )
    p.add_argument(
        "--pod-resources-socket",
        default="/var/lib/kubelet/pod-resources/kubelet.sock",
        help="kubelet pod-resources socket",
    )
    p.add_argument(
        "--alloc-spec-dir",
        default="/host/var/lib/elastic-tpu/alloc",
        help="where allocation specs for the container injection are "
             "written",
    )
    p.add_argument(
        "--nri-socket", default="",
        help="containerd NRI socket; when set the agent registers as an "
             "NRI plugin and injects devices at CreateContainer "
             "(containerd activation; typical: /var/run/nri/nri.sock)",
    )
    p.add_argument(
        "--nri-driver-lib", action="append", default=[], metavar="PATH",
        help="host driver library (e.g. /usr/lib/x86_64-linux-gnu/"
             "libcuda.so.1) to bind-mount read-only at its own path into "
             "GPU containers via NRI; repeatable",
    )
    p.add_argument(
        "--nri-evict-on-chip-failure", action="store_true",
        help="policy: evict containers bound to a card that goes "
             "unhealthy (via NRI UpdateContainers) so the kubelet "
             "restarts them onto healthy cards",
    )
    p.add_argument("--metrics-port", type=int, default=9478,
                   help="observability HTTP port serving /metrics, "
                        "/debug/* and /healthz (0 = off)")
    p.add_argument("--metrics-addr", default="127.0.0.1",
                   help="bind address for the observability endpoint "
                        "(default loopback; 0.0.0.0 allows off-host "
                        "Prometheus scrapes, /debug/* stays loopback-only)")
    p.add_argument("--dp-pool-size", type=int, default=8,
                   help="gRPC worker threads per device-plugin resource "
                        "server; kubelet binds containers concurrently, "
                        "so size this to the expected bind burst")
    p.add_argument("--sampler-period", type=float, default=10.0,
                   help="seconds between utilization/health samples "
                        "(sampler.py)")
    p.add_argument("--no-sampler", action="store_true",
                   help="disable the utilization & health sampler")
    p.add_argument("--no-events", action="store_true",
                   help="disable k8s Event emission (e.g. RBAC without "
                        "events:create)")
    p.add_argument("--no-crd", action="store_true",
                   help="disable ElasticTPU CRD publication")
    p.add_argument("--timeline-cap", type=int, default=None,
                   help="ring cap on the durable lifecycle-event journal "
                        "(timeline.py; default 4096); evictions are "
                        "counted durably either way")
    p.add_argument("--reconcile-period", type=float, default=30.0,
                   help="seconds between continuous-reconciler passes "
                        "(store <-> kubelet <-> disk <-> live-pod drift "
                        "repair; jittered 0.75x-1.25x)")
    p.add_argument("--reconcile-dry-run", action="store_true",
                   help="the reconciler observes and reports divergences "
                        "without repairing; the boot-time restore pass "
                        "still repairs")
    p.add_argument("--drain-deadline", type=float, default=300.0,
                   help="graceful-drain checkpoint deadline (seconds): on "
                        "a maintenance event, preemption notice or "
                        "operator drain, resident pods get this long after "
                        "the ELASTIC_TPU_DRAIN signal before their "
                        "bindings are reclaimed (drain.py)")
    p.add_argument("--drain-period", type=float, default=2.0,
                   help="seconds between drain-orchestrator trigger polls "
                        "(jittered 0.75x-1.25x)")
    p.add_argument("--preemption-notice", type=float, default=30.0,
                   help="spot preemption notice window (seconds): a "
                        "preemption-triggered drain clamps its budget to "
                        "min(--drain-deadline, this); 0 disables the clamp")
    p.add_argument("--goodput-period", type=float, default=10.0,
                   help="seconds between goodput-ledger journal replays "
                        "(per-pod productive/downtime partition and the "
                        "downtime-by-cause metrics; goodput.py)")
    p.add_argument("--repartition-period", type=float, default=10.0,
                   help="seconds between repartition-controller passes "
                        "(live quota moves between pods that opt in via "
                        "elasticgpu.io/repartition; jittered 0.75x-1.25x)")
    p.add_argument("--no-repartition", action="store_true",
                   help="disable live re-partitioning and the QoS "
                        "throttle/evict enforcement (static grants and "
                        "overcommit alarms only)")
    p.add_argument("--qos-evict-after", type=float, default=300.0,
                   help="seconds between the overcommit throttle clamp "
                        "and the binding reclaim of a pod that stays over "
                        "quota (repartition.py)")
    p.add_argument("--migration-period", type=float, default=2.0,
                   help="seconds between migration-coordinator ticks (ack "
                        "consumption, early drain reclaim, MigrationRecord "
                        "publication, inbound resume verification; "
                        "jittered 0.75x-1.25x)")
    p.add_argument("--no-migration", action="store_true",
                   help="disable the checkpoint-handshake migration "
                        "coordinator (drains run to their deadline and "
                        "nothing verifies checkpoints or resumes)")
    p.add_argument("--maintenance-poll-ttl", type=float, default=None,
                   help="seconds one maintenance-event/preempted metadata "
                        "fetch stays cached (default 30; env "
                        "ELASTIC_TPU_MAINTENANCE_POLL_TTL also honored)")
    p.add_argument("--slice-membership-ttl", type=float, default=5.0,
                   help="seconds one apiserver slice-membership snapshot "
                        "stays fresh (slices/registry.py): bounds the "
                        "slice orchestrator's apiserver traffic; lower it "
                        "for faster member-loss detection")
    p.add_argument("--storage-batch-window", type=float, default=0.0,
                   help="group-commit window (seconds) of the checkpoint "
                        "store (storage/batcher.py): 0 = every write "
                        "commits itself; >0 (e.g. 0.005) coalesces "
                        "commits, load-bearing writes still wait for "
                        "their covering commit")
    p.add_argument("--sink-flush-window", type=float, default=0.0,
                   help="coalescing window (seconds) of the CRD and Event "
                        "sinks (0 = drain at once)")
    p.add_argument("--no-event-bus", action="store_true",
                   help="disable the in-process event bus (events.py): "
                        "the reconciler polls at its base period")
    p.add_argument("--event-safety-net-factor", type=float, default=10.0,
                   help="how far the reconciler stretches its periodic "
                        "sweep while the event bus is healthy (clamped "
                        "to >= 1)")
    p.add_argument("--slow-span-ms", type=float, default=None,
                   help="log and journal any trace span slower than this "
                        "many milliseconds as a slow_span timeline event "
                        "(default: the tracer's 250 ms; also "
                        "ELASTIC_TPU_SLOW_SPAN_MS)")
    p.add_argument("--profile-hz", type=float, default=0.0,
                   help="continuous self-profiler sampling rate in Hz "
                        "(0 = off); /debug/profile serves the hottest "
                        "stacks and elastic_tpu_profiler_overhead_ratio "
                        "its measured cost")
    p.add_argument("--crash-loop-threshold", type=int, default=5,
                   help="supervisor circuit breaker: crashes of one "
                        "subsystem within the sliding window before it is "
                        "marked failed (a critical one then stops the "
                        "agent)")
    p.add_argument("--faults", default="",
                   help="TEST-ONLY fault injection spec "
                        "(point=spec,point=spec; e.g. "
                        "'gc.sweep=die-thread:1,storage.save=delay:0.5'); "
                        "also read from ELASTIC_TPU_FAULTS. Never set in "
                        "production")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)
    if args.nri_evict_on_chip_failure and not args.nri_socket:
        p.error(
            "--nri-evict-on-chip-failure requires --nri-socket (evictions "
            "go through the NRI session)"
        )
    return args


# -- node-doctor shared plumbing ----------------------------------------------


_SINCE_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def since_arg(value: str, _now=None) -> float:
    """argparse type for ``--since``: unix epoch seconds, OR a relative
    duration like ``15m`` / ``2h`` / ``90s`` / ``1d`` (resolved against
    now). Junk raises ArgumentTypeError, so argparse exits non-zero
    with a usage message — pinned in tests."""
    raw = value.strip()
    try:
        ts = float(raw)
    except ValueError:
        pass
    else:
        # 'nan'/'inf' parse as floats but make the ts >= ? filter
        # silently match nothing — an operator typo must be an error,
        # not an empty-but-successful read
        if math.isfinite(ts):
            return ts
        raise argparse.ArgumentTypeError(
            f"{value!r} is not a finite timestamp"
        )
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smhd])", raw)
    if not m:
        raise argparse.ArgumentTypeError(
            f"{value!r} is neither unix seconds nor a relative duration "
            "(15m, 2h, 90s, 1d)"
        )
    now = time.time() if _now is None else _now
    return now - float(m.group(1)) * _SINCE_UNITS[m.group(2)]


# -- node-doctor timeline -----------------------------------------------------


def parse_timeline_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="elastic-gpu-agent node-doctor timeline",
        description="Reconstruct a causally-linked lifecycle history "
                    "for one pod/slice/chip/node straight from the "
                    "checkpoint db's durable event journal — works "
                    "against a dead agent's db, exactly like the "
                    "open-intent reader.",
    )
    p.add_argument(
        "--db-file", default="/host/var/lib/elastic-tpu/meta.db",
        help="checkpoint db holding the timeline table",
    )
    p.add_argument("--pod", default=None, metavar="NS/NAME",
                   help="history of one pod (bare names accepted)")
    p.add_argument("--slice", dest="slice_id", default=None,
                   help="history of one slice id")
    p.add_argument("--chip", type=int, default=None,
                   help="history of one chip index")
    p.add_argument("--node", default=None,
                   help="filter to one node name (merged fleet dbs)")
    p.add_argument("--trace", default=None,
                   help="history of one trace/correlation id")
    p.add_argument("--kind", action="append", default=None,
                   help="keep only these event kinds (repeatable)")
    p.add_argument("--since", type=since_arg, default=None,
                   help="unix-seconds lower bound, or a relative "
                        "duration (15m, 2h, 90s, 1d)")
    p.add_argument("--limit", type=int, default=None,
                   help="newest-N cap on the reconstructed history")
    p.add_argument("--no-causal", action="store_true",
                   help="direct key matches only — skip the causal "
                        "expansion along shared trace/slice ids")
    return p.parse_args(argv)


def timeline_main(argv=None) -> int:
    args = parse_timeline_args(argv)
    logging.basicConfig(
        level=logging.WARNING,
        format="%(levelname).1s %(name)s %(message)s",
        stream=sys.stderr,
    )
    if not os.path.exists(args.db_file):
        print(f"no db at {args.db_file}", file=sys.stderr)
        return 1
    from .storage import Storage
    from .timeline import Timeline

    with Storage(args.db_file) as storage:
        view = Timeline(storage)
        events = view.events(
            pod=args.pod, slice_id=args.slice_id, chip=args.chip,
            node=args.node, trace=args.trace, kinds=args.kind,
            since=args.since, limit=args.limit,
            causal=not args.no_causal,
        )
        status = view.status()
        # The cap the WRITING agent ran with (persisted alongside the
        # events), not this reader process's default — an operator
        # judging "could the ring have trimmed history?" needs the
        # real bound.
        status["cap"] = storage.timeline_cap_stored()
    entity = {
        k: v for k, v in (
            ("pod", args.pod), ("slice", args.slice_id),
            ("chip", args.chip), ("node", args.node),
            ("trace", args.trace),
        ) if v is not None
    }
    json.dump({
        "db_file": args.db_file,
        "entity": entity,
        "events": events,
        "journal": {
            "cap": status["cap"],
            "total_events": status["total_events"],
            "evicted_total": status["evicted_total"],
        },
    }, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


# -- node-doctor goodput ------------------------------------------------------


def parse_goodput_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="elastic-gpu-agent node-doctor goodput",
        description="Replay the checkpoint db's durable event journal "
                    "into the goodput ledger: per-pod partitions of "
                    "wall time into productive/checkpointing/migrating/"
                    "draining/throttled/queued/unattributed, each "
                    "non-productive interval attributed to its cause — "
                    "works against a dead agent's db, like node-doctor "
                    "timeline.",
    )
    p.add_argument(
        "--db-file", default="/host/var/lib/elastic-tpu/meta.db",
        help="checkpoint db holding the timeline journal and the goodput "
             "anchors",
    )
    p.add_argument("--pod", default=None, metavar="NS/NAME",
                   help="one pod's ledger (bare names accepted)")
    p.add_argument("--slice", dest="slice_id", default=None,
                   help="ledgers of one slice's member pods")
    p.add_argument("--since", type=since_arg, default=None,
                   help="keep pods whose lifetime reaches past this "
                        "bound: unix seconds or a relative duration "
                        "(15m, 2h, 90s, 1d)")
    return p.parse_args(argv)


def goodput_main(argv=None) -> int:
    """``node-doctor goodput``: the ledger of a db, as JSON on stdout;
    exits 1 when it cannot account for a pod's lifetime."""
    args = parse_goodput_args(argv)
    logging.basicConfig(
        level=logging.WARNING,
        format="%(levelname).1s %(name)s %(message)s",
        stream=sys.stderr,
    )
    if not os.path.exists(args.db_file):
        print(f"no db at {args.db_file}", file=sys.stderr)
        return 1
    from .goodput import build_goodput_block
    from .storage import Storage

    with Storage(args.db_file) as storage:
        block = build_goodput_block(
            storage, pod=args.pod, slice_id=args.slice_id,
            since=args.since,
        )
    entity = {
        k: v for k, v in (
            ("pod", args.pod), ("slice", args.slice_id),
            ("since", args.since),
        ) if v is not None
    }
    json.dump({
        "db_file": args.db_file,
        "entity": entity,
        "goodput": block,
    }, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    # conservation is the contract: a ledger that cannot account for a
    # pod's lifetime is a finding, and the exit code says so
    return 1 if block.get("conservation_problems") else 0


def parse_profile_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="elastic-gpu-agent node-doctor profile",
        description="Fetch /debug/profile from a running agent and "
                    "render the hottest stacks (continuous self-"
                    "profiler; enable with --profile-hz on the agent).",
    )
    p.add_argument(
        "--agent-url", required=True,
        help="base URL of a running agent's observability endpoint "
             "(e.g. http://127.0.0.1:9478)",
    )
    p.add_argument("--top", type=int, default=30,
                   help="stacks to show (hottest first)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw /debug/profile payload instead of "
                        "the rendered view")
    p.add_argument("--timeout", type=float, default=3.0,
                   help="HTTP timeout in seconds")
    return p.parse_args(argv)


def profile_main(argv=None) -> int:
    from .profiler import render_profile
    from .sampler import _fetch_json

    args = parse_profile_args(argv)
    url = f"{args.agent_url.rstrip('/')}/debug/profile?top={args.top}"
    try:
        payload = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001 - one fetch, report and exit
        print(f"cannot fetch {url}: {e}", file=sys.stderr)
        return 1
    if "error" in payload and "samples_total" not in payload:
        # The endpoint answers JSON on every status; a 503 here means
        # the agent is up but the profiler isn't attached yet.
        print(f"agent error: {payload['error']}", file=sys.stderr)
        return 1
    if args.json:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_profile(payload, top=args.top) + "\n")
    return 0


def parse_doctor_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="elastic-gpu-agent node-doctor",
        description="Snapshot devices, health, error counters, "
                    "allocations, sampler windows and recent traces into "
                    "one JSON diagnostics bundle (stdout).",
    )
    p.add_argument("--node-name", default="", help="node name for the bundle")
    p.add_argument(
        "--operator", default="nvidia",
        help="device operator to inspect: nvidia | stub[:<cards>] | "
             "exclusive[:<inner>]",
    )
    p.add_argument("--dev-root", default="/host/dev", help="host /dev mount")
    p.add_argument(
        "--db-file", default="/host/var/lib/elastic-tpu/meta.db",
        help="checkpoint db to read allocations from (skipped if absent)",
    )
    p.add_argument(
        "--alloc-spec-dir", default="/host/var/lib/elastic-tpu/alloc",
        help="alloc-spec dir (trace-id correlation)",
    )
    p.add_argument(
        "--agent-url", default="",
        help="base URL of a running agent's observability endpoint "
             "(e.g. http://127.0.0.1:9478) to include live traces and "
             "the live allocation table",
    )
    p.add_argument("--samples", type=int, default=3,
                   help="utilization samples to take before bundling")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between samples")
    p.add_argument("--trace-limit", type=int, default=50,
                   help="max traces pulled into the bundle")
    p.add_argument(
        "--validate", default="", metavar="BUNDLE_JSON",
        help="validate an existing bundle file against the schema and "
             "exit (no snapshot is taken)",
    )
    return p.parse_args(argv)


def bundle_main(argv=None) -> int:
    """``node-doctor`` with no subcommand: a diagnostics bundle on stdout
    (pure JSON; the rest goes to stderr), or with ``--validate`` the
    schema check of a bundle file."""
    from .sampler import (
        UtilizationSampler,
        build_diagnostics_bundle,
        validate_bundle,
    )

    args = parse_doctor_args(argv)
    logging.basicConfig(
        level=logging.WARNING,
        format="%(levelname).1s %(name)s %(message)s",
        stream=sys.stderr,
    )
    if args.validate:
        try:
            with open(args.validate) as f:
                bundle = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read bundle {args.validate}: {e}", file=sys.stderr)
            return 1
        problems = validate_bundle(bundle)
        if problems:
            for problem in problems:
                print(f"INVALID: {problem}", file=sys.stderr)
            return 1
        print(f"bundle {args.validate} is valid", file=sys.stderr)
        return 0
    from .manager import build_operator
    from .tracing import get_tracer

    operator = build_operator(
        ManagerOptions(operator_kind=args.operator, dev_root=args.dev_root)
    )
    storage = None
    if os.path.exists(args.db_file):
        from .storage import Storage

        storage = Storage(args.db_file)
    sampler = UtilizationSampler(
        operator, storage=storage, alloc_spec_dir=args.alloc_spec_dir,
        period_s=max(args.interval, 0.0),
    )
    for i in range(max(1, args.samples)):
        sampler.sample_once()
        if i + 1 < max(1, args.samples) and args.interval > 0:
            time.sleep(args.interval)
    bundle = build_diagnostics_bundle(
        operator,
        sampler=sampler,
        tracer=None if args.agent_url else get_tracer(),
        node_name=args.node_name,
        agent_url=args.agent_url,
        trace_limit=args.trace_limit,
        storage=storage,
    )
    if storage is not None:
        storage.close()
    json.dump(bundle, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


def doctor_main(argv=None) -> int:
    if argv and argv[0] == "timeline":
        return timeline_main(argv[1:])
    if argv and argv[0] == "goodput":
        return goodput_main(argv[1:])
    if argv and argv[0] == "profile":
        return profile_main(argv[1:])
    return bundle_main(argv)


# -- perf-gate ----------------------------------------------------------------


def parse_perf_gate_args(argv=None) -> argparse.Namespace:
    from . import bench_history as bh

    p = argparse.ArgumentParser(
        prog="elastic-gpu-agent perf-gate",
        description="Perf-regression ledger: parse the committed "
                    "BENCH_r*.json trajectory into per-leg time series "
                    "and fail when a tracked latency regresses beyond "
                    "tolerance against the recent-median baseline.",
    )
    p.add_argument("--root", default=".",
                   help="directory holding BENCH_r*.json rounds")
    p.add_argument("--include", action="append", default=[],
                   metavar="FILE",
                   help="extra bench JSON file(s) to fold into the "
                        "history (repeatable; e.g. a fresh uncommitted "
                        "round)")
    p.add_argument("--tolerance", type=float,
                   default=bh.DEFAULT_TOLERANCE,
                   help="allowed fractional regression over the "
                        "baseline median (0.5 = +50%%)")
    p.add_argument("--floor-ms", type=float, default=bh.DEFAULT_FLOOR_MS,
                   help="absolute slack added to every limit — keeps "
                        "sub-millisecond legs from tripping on noise")
    p.add_argument("--window", type=int, default=bh.DEFAULT_WINDOW,
                   help="prior rounds whose median forms the baseline")
    p.add_argument("--series", action="store_true",
                   help="print the parsed per-leg time series before "
                        "gating (debugging aid)")
    p.add_argument("--self-test", action="store_true",
                   help="also seed a synthetic regression on top of the "
                        "real history and fail unless the gate catches "
                        "it on every tracked series")
    return p.parse_args(argv)


def perf_gate_main(argv=None) -> int:
    from . import bench_history as bh

    args = parse_perf_gate_args(argv)
    rounds, problems = bh.load_history(args.root, include=args.include)
    problems.extend(bh.validate_history(rounds))
    if not problems:
        if args.series:
            all_tracked = (
                *bh.TRACKED, *bh.TRACKED_RATIOS, *bh.TRACKED_EVENT,
                *bh.TRACKED_MIGRATION,
            )
            for name, points in sorted(
                bh.series(rounds, all_tracked).items()
            ):
                path = " ".join(
                    f"r{n:02d}={v:.3f}" for n, v in points
                )
                print(f"# {name}: {path}", file=sys.stderr)
        problems.extend(bh.perf_gate(
            rounds, tolerance=args.tolerance,
            floor_ms=args.floor_ms, window=args.window,
        ))
        if args.self_test:
            problems.extend(bh.self_test(
                rounds, tolerance=args.tolerance,
                floor_ms=args.floor_ms, window=args.window,
            ))
    if problems:
        for problem in problems:
            print(f"PERF-GATE: {problem}", file=sys.stderr)
        return 1
    tracked = ", ".join(
        name for name, _ in
        (*bh.TRACKED, *bh.TRACKED_RATIOS, *bh.TRACKED_EVENT,
         *bh.TRACKED_MIGRATION)
    )
    print(
        f"perf-gate OK: {len(rounds)} round(s), tracked [{tracked}]"
        + (" + self-test" if args.self_test else ""),
        file=sys.stderr,
    )
    return 0


def options_from_args(args: argparse.Namespace) -> ManagerOptions:
    return ManagerOptions(
        node_name=args.node_name,
        db_path=args.db_file,
        kubeconfig=args.kubeconf,
        plugin_kind=args.plugin,
        operator_kind=args.operator,
        dev_root=args.dev_root,
        device_plugin_dir=args.device_plugin_dir,
        pod_resources_socket=args.pod_resources_socket,
        alloc_spec_dir=args.alloc_spec_dir,
        nri_socket=args.nri_socket,
        nri_driver_libs=list(args.nri_driver_lib),
        nri_evict_on_chip_failure=args.nri_evict_on_chip_failure,
        dp_pool_size=args.dp_pool_size,
        crash_loop_threshold=args.crash_loop_threshold,
        reconcile_period_s=args.reconcile_period,
        reconcile_dry_run=args.reconcile_dry_run,
        slice_membership_ttl_s=args.slice_membership_ttl,
        enable_events=not args.no_events,
        enable_crd=not args.no_crd,
        enable_sampler=not args.no_sampler,
        sampler_period_s=args.sampler_period,
        drain_deadline_s=args.drain_deadline,
        drain_period_s=args.drain_period,
        preemption_notice_s=args.preemption_notice,
        maintenance_poll_ttl_s=args.maintenance_poll_ttl,
        enable_repartition=not args.no_repartition,
        repartition_period_s=args.repartition_period,
        qos_evict_after_s=args.qos_evict_after,
        enable_migration=not args.no_migration,
        migration_period_s=args.migration_period,
        goodput_period_s=args.goodput_period,
        slow_span_ms=args.slow_span_ms,
        profile_hz=args.profile_hz,
        storage_batch_window_s=args.storage_batch_window,
        sink_flush_window_s=args.sink_flush_window,
        enable_event_bus=not args.no_event_bus,
        event_safety_net_factor=args.event_safety_net_factor,
        **({"timeline_cap": args.timeline_cap}
           if args.timeline_cap is not None else {}),
    )


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "node-doctor":
        return doctor_main(argv[1:])
    if argv and argv[0] == "perf-gate":
        return perf_gate_main(argv[1:])
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s",
        stream=sys.stderr,
    )
    install_dump_signal()

    fault_spec = args.faults or os.environ.get("ELASTIC_TPU_FAULTS", "")
    if fault_spec:
        from . import faults

        logging.getLogger(__name__).warning(
            "fault injection ARMED (test-only): %s", fault_spec
        )
        faults.get_registry().arm_spec(fault_spec)

    metrics = None
    if args.metrics_port:
        from .metrics import AgentMetrics

        metrics = AgentMetrics()
        # a busy port must not take the allocation path down: the agent
        # runs on and the endpoint keeps retrying the bind
        metrics.serve_with_retry(args.metrics_port, addr=args.metrics_addr)
    # the process-wide net: threads nobody registered with the supervisor
    # still cannot die unobserved
    from .supervisor import install_thread_excepthook

    install_thread_excepthook(metrics)

    opts = options_from_args(args)
    opts.metrics = metrics
    manager = NodeManager(opts)
    run_thread = threading.Thread(
        target=manager.run, kwargs={"block": True}, daemon=True, name="manager"
    )
    run_thread.start()
    sig = wait_for_exit_signal()
    logging.getLogger(__name__).info("exiting on signal %s", sig)
    manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's node agent entry point.

The counterpart of ``elastic_tpu_agent/cli.py``'s agent process: flags ->
``NodeManager`` -> run in a thread -> stop on SIGTERM/SIGINT/SIGQUIT, with
a SIGUSR1 stack dump. The flags are the agent's for the ported
subsystems, with the port's defaults (operator ``nvidia``; the device
plugins advertise ``elasticgpu.io/gpu-core`` and ``gpu-memory``). A node
needs grpcio and protobuf for the kubelet's APIs.

Usage:
    python3 -m elastic_tpu_agent_torch.cli --node-name $NODE_NAME \\
        --db-file /host/var/lib/elastic-tpu/meta.db --operator nvidia

The agent's ``node-doctor`` and ``perf-gate`` subcommands come with the
timeline and metrics slices.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading

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
    p.add_argument("--dp-pool-size", type=int, default=8,
                   help="gRPC worker threads per device-plugin resource "
                        "server; kubelet binds containers concurrently, "
                        "so size this to the expected bind burst")
    p.add_argument("--reconcile-period", type=float, default=30.0,
                   help="seconds between continuous-reconciler passes "
                        "(store <-> kubelet <-> disk <-> live-pod drift "
                        "repair; jittered 0.75x-1.25x)")
    p.add_argument("--reconcile-dry-run", action="store_true",
                   help="the reconciler observes and reports divergences "
                        "without repairing; the boot-time restore pass "
                        "still repairs")
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
    return p.parse_args(argv)


def options_from_args(args: argparse.Namespace) -> ManagerOptions:
    return ManagerOptions(
        node_name=args.node_name,
        db_path=args.db_file,
        kubeconfig=args.kubeconf,
        operator_kind=args.operator,
        dev_root=args.dev_root,
        device_plugin_dir=args.device_plugin_dir,
        pod_resources_socket=args.pod_resources_socket,
        alloc_spec_dir=args.alloc_spec_dir,
        dp_pool_size=args.dp_pool_size,
        crash_loop_threshold=args.crash_loop_threshold,
        reconcile_period_s=args.reconcile_period,
        reconcile_dry_run=args.reconcile_dry_run,
    )


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
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

    # the process-wide net: threads nobody registered with the supervisor
    # still cannot die unobserved
    from .supervisor import install_thread_excepthook

    install_thread_excepthook()

    manager = NodeManager(options_from_args(args))
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

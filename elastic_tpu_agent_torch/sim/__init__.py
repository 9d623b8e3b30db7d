"""Cluster-in-a-box fleet simulator and the observability layer over it.

The port's copy of ``elastic_tpu_agent/sim/``: N complete in-process
agents of the port (``NodeManager`` with its ``gpushare`` plugins), each
against its own fake kubelet (``tests/torch_fake_kubelet.py``, built on
the port's ``rpc`` and ``gen``) and its own operator, all sharing ONE fake
apiserver (``tests/fake_apiserver.py``, standard library only), read the
way production would: by scraping every agent's /metrics endpoint.

- fleet.py: FleetSim, which builds, starts, drives and stops the fleet;
  a dev/bench tool, never shipped in the DaemonSet image.
- aggregator.py: FleetAggregator, which scrapes each agent over HTTP,
  merges histogram buckets for fleet-level quantiles, computes per-bind
  request amplification, tracks per-node reconcile convergence and
  follows admission-stamped trace ids to whichever node bound the pod.
- traffic.py: TraceGenerator, seeded and replayable request/pod arrival
  traces (diurnal load, flash crowds, prefix-cache-hostile prompts,
  mixed train/serve tenancy); same seed => byte-identical trace.
- scale.py: ScaleHarness, thousand-pod churn through scenario phases, and
  scale_problems(), the structural checker of scale and chaos reports.
- chaos.py: ChaosMatrix, overlapping fault programs (brownouts, flaky
  disks, drains, kubelet flaps, throttles) replayed over live traffic,
  scored by fleet goodput and SLO attainment.

Nothing here is imported by the agent's processes; importing the package
loads no torch (the workload-side pieces a scenario uses, the request
observatory and the stub workload's lifecycle watcher, load lazily).
"""

from .aggregator import FleetAggregator, histogram_quantile  # noqa: F401
from .chaos import (  # noqa: F401
    ChaosMatrix, ChaosProgram, OpCursor, ScenarioRunner, repro_line,
)
from .fleet import FleetSim  # noqa: F401
from .scale import ScaleHarness, scale_problems  # noqa: F401
from .traffic import Trace, TraceCursor, TraceGenerator  # noqa: F401

"""Perf-regression ledger: a bench trajectory, read back and gated.

The port's own copy of the agent's ``bench_history.py``, agent-side: it
imports no torch and nothing of the JAX package (the standard library
only). It reads rounds in ``bench.py``'s schema, ``BENCH_r<NN>.json``
under a root plus any files handed to it, into a schema-validated
per-leg time series, and gates on it: ``elastic-gpu-agent perf-gate``
(``cli.py``) fails when the newest round's tracked latency regresses
beyond tolerance against the recent trajectory. The port writes no
rounds yet; its bench will write them under the same key paths
(``extra.ours.*``, ``extra.event_core.*``, ``extra.migration_core.*``,
the ratio legs), which this module then reads unchanged.

Gate rule (deliberately robust to noisy boxes): for each tracked
lower-is-better series, the baseline is the **median of the last
``window`` rounds before the newest**; the newest value regresses when
it exceeds ``baseline * (1 + tolerance) + floor_ms``. A trajectory
legitimately drifts as scenarios get harder (rounds add pods/host
load), so the tolerance is wide: this gate catches "something
doubled", not "something grew 5%".

Every function returns a problems list (empty = clean), and the module
carries self-tests that PROVE the gate trips on a seeded regression: a
gate that cannot fail is not a gate.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import re
import statistics
from typing import Dict, List, Optional, Tuple

# Tracked per-leg series: (name, path into a round's JSON). All
# lower-is-better milliseconds, from the bench's own-pipeline block.
TRACKED: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("allocate_p50_ms", ("parsed", "extra", "ours", "allocate_p50_ms")),
    ("prestart_p50_ms", ("parsed", "extra", "ours", "prestart_p50_ms")),
    ("bind_p50_ms", ("parsed", "extra", "ours", "bind_p50_ms")),
    ("bind_p99_ms", ("parsed", "extra", "ours", "bind_p99_ms")),
)

# Serving-plane series: HIGHER-is-better ratios (prefix-cache prefill
# reduction, live-repartition speedup). These legs entered the bench
# later than the bind legs, so rounds without the leaf contribute no
# point — the gate never retro-fails old history — but once a leg
# publishes, a collapse in its ratio trips the gate exactly like a
# bind-latency regression does.
TRACKED_RATIOS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("serving_prefill_reduction",
     ("parsed", "extra", "request_obs", "prefill_reduction")),
    ("qos_live_speedup",
     ("parsed", "extra", "qos_repartition", "live_speedup")),
)

# Event-core series: lower-is-better milliseconds from the fleet
# bench's event leg (bench.py run_event_leg). Like the ratio series
# these entered the bench after the committed history began, so they
# are tolerant-of-missing — rounds that predate the event core simply
# contribute no point and are NOT schema errors — but once published,
# an event-to-repair or churn-bind-p99 blowup trips the gate exactly
# like a bind-latency regression does.
TRACKED_EVENT: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("event_to_repair_ms",
     ("parsed", "extra", "event_core", "event_to_repair_ms")),
    ("bind_churn_p99_ms",
     ("parsed", "extra", "event_core", "bind_churn_p99_ms")),
)

# Migration series: lower-is-better, from the bench's migration_core
# block (lifted out of the fleet leg's pre-copy scenario).
# ``migration_downtime_ms`` is the cutover pause — the headline the
# sub-second-migration work exists to keep small — and
# ``migration_delta_bytes_ratio`` is final-delta/full-state, whose
# blowup means delta streaming degraded back toward shipping full
# checkpoints. Both tolerant-of-missing like the other late-entry
# series; the ratio uses DEFAULT_FLOOR_RATIO for slack (a 0.25ms floor
# would swamp a unitless ~0.04 ratio).
TRACKED_MIGRATION: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("migration_downtime_ms",
     ("parsed", "extra", "migration_core", "migration_downtime_ms")),
    ("migration_delta_bytes_ratio",
     ("parsed", "extra", "migration_core", "migration_delta_bytes_ratio")),
)

DEFAULT_TOLERANCE = 0.5   # +50% over the rolling-median baseline
DEFAULT_FLOOR_MS = 0.25   # plus absolute slack: sub-ms jitter never trips
DEFAULT_FLOOR_RATIO = 0.05  # ratio-series absolute slack (unitless)
DEFAULT_WINDOW = 3        # baseline = median of this many prior rounds
MIN_ROUNDS = 2            # one round has no trajectory to regress against

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


def _dig(data: dict, path: Tuple[str, ...]):
    node = data
    for key in path:
        if not isinstance(node, dict):
            return None
        node = node.get(key)
    return node


def load_history(
    root: str = ".", include: Optional[List[str]] = None
) -> Tuple[List[dict], List[str]]:
    """Load the committed BENCH_r*.json trajectory (plus any ``include``
    files, e.g. a smoke's structural-latency record) into round dicts
    ``{"n", "path", "data"}`` sorted by round number. Unreadable files
    are problems, not crashes."""
    problems: List[str] = []
    rounds: List[dict] = []
    paths = sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
    for path in [*paths, *(include or [])]:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"{path}: unreadable ({e})")
            continue
        match = _ROUND_RE.search(os.path.basename(path))
        n = data.get("n")
        if not isinstance(n, int):
            n = int(match.group(1)) if match else len(rounds) + 1
        rounds.append({"n": n, "path": path, "data": data})
    rounds.sort(key=lambda r: (r["n"], r["path"]))
    return rounds, problems


def validate_round(data: dict, path: str = "") -> List[str]:
    """Schema-check one round snapshot; returns problems (empty =
    valid). The schema is the shape bench.py has always written —
    validated now so a malformed snapshot fails the gate loudly
    instead of silently dropping out of the series."""
    where = path or "<round>"
    problems: List[str] = []
    if not isinstance(data, dict):
        return [f"{where}: round is not an object"]
    if not isinstance(data.get("n"), int) or data["n"] < 1:
        problems.append(f"{where}: 'n' must be a positive integer")
    if not isinstance(data.get("cmd"), str) or not data.get("cmd"):
        problems.append(f"{where}: 'cmd' must be a non-empty string")
    if not isinstance(data.get("rc"), int):
        problems.append(f"{where}: 'rc' must be an integer")
    parsed = data.get("parsed")
    if not isinstance(parsed, dict):
        problems.append(f"{where}: 'parsed' block missing")
        return problems
    if not isinstance(parsed.get("metric"), str) or not parsed.get("metric"):
        problems.append(f"{where}: parsed.metric must be a non-empty string")
    if not isinstance(parsed.get("value"), (int, float)) or isinstance(
        parsed.get("value"), bool
    ):
        problems.append(f"{where}: parsed.value must be a number")
    extra = parsed.get("extra")
    if extra is not None and not isinstance(extra, dict):
        problems.append(f"{where}: parsed.extra must be an object")
        extra = None
    ours = (extra or {}).get("ours")
    if ours is not None:
        if not isinstance(ours, dict):
            problems.append(f"{where}: parsed.extra.ours must be an object")
        else:
            for name, _path in TRACKED:
                value = ours.get(_path[-1])
                if value is None:
                    problems.append(
                        f"{where}: parsed.extra.ours.{_path[-1]} missing"
                    )
                elif not isinstance(value, (int, float)) or isinstance(
                    value, bool
                ) or value < 0:
                    problems.append(
                        f"{where}: parsed.extra.ours.{_path[-1]} must be a "
                        "non-negative number"
                    )
    return problems


def validate_history(rounds: List[dict]) -> List[str]:
    problems: List[str] = []
    seen_n: Dict[int, str] = {}
    for r in rounds:
        problems.extend(validate_round(r["data"], r["path"]))
        prev = seen_n.get(r["n"])
        if prev is not None:
            problems.append(
                f"{r['path']}: duplicate round n={r['n']} (also {prev})"
            )
        seen_n[r["n"]] = r["path"]
    return problems


def series(
    rounds: List[dict],
    tracked: Tuple[Tuple[str, Tuple[str, ...]], ...] = TRACKED,
) -> Dict[str, List[Tuple[int, float]]]:
    """Per-leg time series: tracked metric name -> [(round n, value)].
    Rounds missing a metric simply contribute no point (the gate
    judges the series that exist)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for r in rounds:
        for name, path in tracked:
            value = _dig(r["data"], path)
            if isinstance(value, (int, float)) and not isinstance(
                value, bool
            ):
                out.setdefault(name, []).append((r["n"], float(value)))
    return out


def perf_gate(
    rounds: List[dict],
    tolerance: float = DEFAULT_TOLERANCE,
    floor_ms: float = DEFAULT_FLOOR_MS,
    window: int = DEFAULT_WINDOW,
) -> List[str]:
    """The regression gate; returns problems (empty = trajectory
    clean). Each tracked series' newest point is judged against the
    median of the ``window`` points before it."""
    problems: List[str] = []
    if len(rounds) < MIN_ROUNDS:
        return problems  # one point is a datum, not a trajectory
    for name, points in sorted(series(rounds, TRACKED + TRACKED_EVENT).items()):
        if len(points) < MIN_ROUNDS:
            continue
        n, latest = points[-1]
        prior = [v for _, v in points[:-1]][-max(1, window):]
        baseline = statistics.median(prior)
        limit = baseline * (1.0 + tolerance) + floor_ms
        if latest > limit:
            problems.append(
                f"REGRESSION {name}: round {n} measured {latest:.3f}ms "
                f"> {limit:.3f}ms allowed "
                f"(baseline median {baseline:.3f}ms over last "
                f"{len(prior)} round(s), tolerance +{tolerance:.0%} "
                f"+ {floor_ms}ms)"
            )
    # migration series: lower-is-better like the latency series, but
    # the bytes ratio is unitless so its absolute slack is
    # DEFAULT_FLOOR_RATIO, not the millisecond floor
    for name, points in sorted(series(rounds, TRACKED_MIGRATION).items()):
        if len(points) < MIN_ROUNDS:
            continue
        n, latest = points[-1]
        prior = [v for _, v in points[:-1]][-max(1, window):]
        baseline = statistics.median(prior)
        is_ms = name.endswith("_ms")
        floor = floor_ms if is_ms else DEFAULT_FLOOR_RATIO
        unit = "ms" if is_ms else "x"
        limit = baseline * (1.0 + tolerance) + floor
        if latest > limit:
            problems.append(
                f"REGRESSION {name}: round {n} measured "
                f"{latest:.3f}{unit} > {limit:.3f}{unit} allowed "
                f"(baseline median {baseline:.3f}{unit} over last "
                f"{len(prior)} round(s), tolerance +{tolerance:.0%} "
                f"+ {floor}{unit})"
            )
    # serving ratio series: inverted trip (a COLLAPSED ratio is the
    # regression), same rolling-median baseline
    for name, points in sorted(series(rounds, TRACKED_RATIOS).items()):
        if len(points) < MIN_ROUNDS:
            continue
        n, latest = points[-1]
        prior = [v for _, v in points[:-1]][-max(1, window):]
        baseline = statistics.median(prior)
        limit = baseline * (1.0 - tolerance) - DEFAULT_FLOOR_RATIO
        if latest < limit:
            problems.append(
                f"REGRESSION {name}: round {n} measured {latest:.3f}x "
                f"< {limit:.3f}x allowed "
                f"(baseline median {baseline:.3f}x over last "
                f"{len(prior)} round(s), tolerance -{tolerance:.0%} "
                f"- {DEFAULT_FLOOR_RATIO})"
            )
    return problems


def self_test(
    rounds: List[dict],
    tolerance: float = DEFAULT_TOLERANCE,
    floor_ms: float = DEFAULT_FLOOR_MS,
    window: int = DEFAULT_WINDOW,
) -> List[str]:
    """Prove the gate can fail: seed a synthetic regression (the newest
    round's tracked latencies multiplied well past tolerance) and
    assert the gate trips on every tracked series. Returns problems
    with the GATE (empty = the gate demonstrably works)."""
    if len(rounds) < MIN_ROUNDS:
        return ["self-test needs at least two committed rounds"]
    seeded = copy.deepcopy(rounds[-1])
    seeded["n"] = rounds[-1]["n"] + 1
    seeded["path"] = "<seeded-regression>"
    factor = (1.0 + tolerance) * 4
    ours = _dig(seeded["data"], ("parsed", "extra", "ours"))
    if not isinstance(ours, dict):
        return ["self-test: newest round has no parsed.extra.ours block"]
    for name, path in TRACKED:
        value = ours.get(path[-1])
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            ours[path[-1]] = value * factor + 10 * floor_ms
    tripped = perf_gate(
        [*rounds, seeded], tolerance=tolerance,
        floor_ms=floor_ms, window=window,
    )
    problems: List[str] = []
    caught = {p.split()[1].rstrip(":") for p in tripped}
    for name, path in TRACKED:
        if path[-1] in ours and name not in caught:
            problems.append(
                f"self-test: seeded {factor:.1f}x regression on {name} "
                "did NOT trip the gate"
            )
    problems.extend(ratio_self_test(
        rounds, tolerance=tolerance, window=window,
    ))
    problems.extend(event_self_test(
        rounds, tolerance=tolerance, floor_ms=floor_ms, window=window,
    ))
    problems.extend(migration_self_test(
        rounds, tolerance=tolerance, floor_ms=floor_ms, window=window,
    ))
    return problems


def ratio_self_test(
    rounds: List[dict],
    tolerance: float = DEFAULT_TOLERANCE,
    window: int = DEFAULT_WINDOW,
) -> List[str]:
    """Prove the inverted (higher-is-better) gate can fail too: seed a
    collapsed serving ratio and assert it trips. Uses the committed
    trajectory when it carries serving points; otherwise a synthetic
    three-round trajectory — the committed history predates the
    serving legs, and a gate whose failure mode is only provable on
    future data is not yet a gate."""
    name, path = TRACKED_RATIOS[0]  # serving_prefill_reduction
    base = [r for r in rounds if isinstance(_dig(r["data"], path),
                                            (int, float))]
    if len(base) >= MIN_ROUNDS:
        trajectory = base
        seeded = copy.deepcopy(base[-1])
        seeded["n"] = base[-1]["n"] + 1
    else:
        trajectory = []
        for i, value in enumerate((4.0, 4.2, 4.1)):
            data: dict = {}
            node = data
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value
            trajectory.append({
                "n": i + 1, "path": f"<synthetic-{i + 1}>",
                "data": data,
            })
        seeded = copy.deepcopy(trajectory[-1])
        seeded["n"] = trajectory[-1]["n"] + 1
    seeded["path"] = "<seeded-ratio-regression>"
    node = seeded["data"]
    for key in path[:-1]:
        node = node.setdefault(key, {})
    collapsed = float(node[path[-1]]) * (1.0 - tolerance) / 4.0
    node[path[-1]] = collapsed
    tripped = perf_gate(
        [*trajectory, seeded], tolerance=tolerance, window=window,
    )
    if not any(f"REGRESSION {name}" in p for p in tripped):
        return [
            f"self-test: seeded collapse of {name} to {collapsed:.3f}x "
            "did NOT trip the gate"
        ]
    return []


def migration_self_test(
    rounds: List[dict],
    tolerance: float = DEFAULT_TOLERANCE,
    floor_ms: float = DEFAULT_FLOOR_MS,
    window: int = DEFAULT_WINDOW,
) -> List[str]:
    """Prove the migration gate can fail: seed a cutover-downtime
    blowup (pre-copy silently degrading to a full-checkpoint pause)
    and a delta-bytes-ratio blowup (delta streaming shipping most of
    the state again) and assert each trips. Uses the committed
    trajectory once it carries migration_core points; until then a
    synthetic three-round trajectory — same rationale as the other
    late-entry series' self-tests."""
    problems: List[str] = []
    synthetic = {
        "migration_downtime_ms": (180.0, 220.0, 200.0),
        "migration_delta_bytes_ratio": (0.12, 0.15, 0.13),
    }
    for name, path in TRACKED_MIGRATION:
        base = [r for r in rounds if isinstance(_dig(r["data"], path),
                                                (int, float))]
        if len(base) >= MIN_ROUNDS:
            trajectory = base
            seeded = copy.deepcopy(base[-1])
            seeded["n"] = base[-1]["n"] + 1
        else:
            trajectory = []
            for i, value in enumerate(synthetic[name]):
                data: dict = {}
                node = data
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = value
                trajectory.append({
                    "n": i + 1, "path": f"<synthetic-{i + 1}>",
                    "data": data,
                })
            seeded = copy.deepcopy(trajectory[-1])
            seeded["n"] = trajectory[-1]["n"] + 1
        seeded["path"] = "<seeded-migration-regression>"
        node = seeded["data"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        floor = floor_ms if name.endswith("_ms") else DEFAULT_FLOOR_RATIO
        blown = float(node[path[-1]]) * (1.0 + tolerance) * 4 + 10 * floor
        node[path[-1]] = blown
        tripped = perf_gate(
            [*trajectory, seeded], tolerance=tolerance,
            floor_ms=floor_ms, window=window,
        )
        if not any(f"REGRESSION {name}" in p for p in tripped):
            problems.append(
                f"self-test: seeded blowup of {name} to {blown:.3f} "
                "did NOT trip the gate"
            )
    return problems


def event_self_test(
    rounds: List[dict],
    tolerance: float = DEFAULT_TOLERANCE,
    floor_ms: float = DEFAULT_FLOOR_MS,
    window: int = DEFAULT_WINDOW,
) -> List[str]:
    """Prove the event-core gate can fail: for each event series, seed
    a blown-up latency and assert it trips. Uses the committed
    trajectory once it carries event-core points; until then a
    synthetic three-round trajectory — same rationale as
    ratio_self_test: a gate whose failure mode is only provable on
    future data is not yet a gate."""
    problems: List[str] = []
    for name, path in TRACKED_EVENT:
        base = [r for r in rounds if isinstance(_dig(r["data"], path),
                                                (int, float))]
        if len(base) >= MIN_ROUNDS:
            trajectory = base
            seeded = copy.deepcopy(base[-1])
            seeded["n"] = base[-1]["n"] + 1
        else:
            trajectory = []
            for i, value in enumerate((20.0, 22.0, 21.0)):
                data: dict = {}
                node = data
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = value
                trajectory.append({
                    "n": i + 1, "path": f"<synthetic-{i + 1}>",
                    "data": data,
                })
            seeded = copy.deepcopy(trajectory[-1])
            seeded["n"] = trajectory[-1]["n"] + 1
        seeded["path"] = "<seeded-event-regression>"
        node = seeded["data"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        blown = float(node[path[-1]]) * (1.0 + tolerance) * 4 + 10 * floor_ms
        node[path[-1]] = blown
        tripped = perf_gate(
            [*trajectory, seeded], tolerance=tolerance,
            floor_ms=floor_ms, window=window,
        )
        if not any(f"REGRESSION {name}" in p for p in tripped):
            problems.append(
                f"self-test: seeded blowup of {name} to {blown:.3f}ms "
                "did NOT trip the gate"
            )
    return problems

"""Trace-driven traffic: seeded, replayable request/pod arrival traces.

The port's copy of ``elastic_tpu_agent/sim/traffic.py``, standard library
only: the same seed gives byte-identical trace lines and digest in both
packages (``tests/test_torch_sim.py`` holds them equal).

Chaos scoring (sim/chaos.py) is only as honest as the traffic it runs
over: scripted two-pod scenarios cannot surface the races that live in
admission waves, prefix-cache churn and mixed tenancy. This generator
emits the ugly day's *workload* half — a deterministic event stream
that the chaos runner replays against a real FleetSim through the real
admission paths, so every run is reproducible from its ``trace_seed``
alone.

What a trace contains (all from ONE ``random.Random(seed)`` stream, so
same seed ⇒ the same events in the same order, byte-identical when
serialized):

- **diurnal load** — request arrival rate follows a compressed sine
  "day" around ``base_rps``, so scenarios see both trough and rush-hour
  admission pressure inside a few seconds of sim time;
- **flash crowds** — short seeded windows where the arrival rate
  multiplies (the retweeted-demo moment), landing mid-scenario so
  faults overlap the surge;
- **prefix-cache-hostile prompts** — each request carries a block-chain
  digest path. ``friendly`` requests share long common prefixes (the
  affinity-cache's best case); ``hostile`` requests draw adversarial
  chains that share block 0 and then diverge immediately — maximal
  digest-table pressure, zero reuse beyond the root, defeating
  prefix-affinity routing by construction;
- **mixed tenancy** — pod arrival/departure events interleave ``serve``
  pods (the request engines' homes) with ``train`` pods that churn
  through admission/bind/delete, so serving SLOs are scored while
  training tenants fight for the same nodes.

The trace is *pure data* (`Trace.lines()` is canonical JSON, one event
per line, sorted keys, fixed float formatting): generation never reads
clocks or touches the fleet. Replay pacing belongs to the driver —
``TraceCursor`` hands out events whose trace-time has come, against
whatever clock the chaos program runs on (ManualClock in tests).
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from typing import Dict, Iterator, List, Optional

# Request SLO classes must match the observatory's label space
# (workloads/request_obs.py SLO_CLASSES) or every admit coerces to
# the default class and the per-class attainment score goes blind.
SLO_CLASSES = ("ttft", "tpot", "batch")

# Digest-path shape: chains are this many blocks deep; friendly traffic
# shares prefixes from a pool this wide.
CHAIN_DEPTH = 8
FRIENDLY_PREFIX_POOL = 4


def _digest(*parts: object) -> str:
    """Stable short content digest (the block-chain digest stand-in the
    observatory attributes prefill cache hits to)."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode())
    return h.hexdigest()[:16]


class Trace:
    """One generated trace: events sorted by time, plus the recipe that
    produced them (seed + knobs) for the repro line."""

    def __init__(self, seed: int, meta: Dict, events: List[dict]) -> None:
        self.seed = seed
        self.meta = meta
        self.events = events

    def lines(self) -> List[str]:
        """Canonical serialization: one JSON object per event, sorted
        keys, no whitespace — byte-identical across runs of one seed
        (the determinism contract tests assert on these bytes)."""
        return [
            json.dumps(e, sort_keys=True, separators=(",", ":"))
            for e in self.events
        ]

    def digest(self) -> str:
        """Content digest of the canonical serialization — what the
        chaos report prints so two runs can be compared at a glance."""
        h = hashlib.sha256()
        for line in self.lines():
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()[:16]

    def requests(self) -> List[dict]:
        return [e for e in self.events if e["kind"] == "request"]

    def pod_events(self) -> List[dict]:
        return [e for e in self.events if e["kind"].startswith("pod_")]


class TraceGenerator:
    """Seeded generator for replayable request/pod arrival traces.

    All randomness flows from one ``random.Random(seed)`` consumed in a
    fixed order; every knob is part of the recipe recorded in
    ``Trace.meta`` so a repro line can rebuild the exact trace.
    """

    def __init__(
        self,
        seed: int,
        duration_s: float = 4.0,
        base_rps: float = 12.0,
        diurnal_amplitude: float = 0.6,
        day_length_s: float = 4.0,
        flash_crowds: int = 1,
        flash_multiplier: float = 4.0,
        flash_duration_s: float = 0.5,
        hostile_fraction: float = 0.5,
        train_pods: int = 2,
        train_pod_lifetime_s: float = 1.5,
        slo_mix: Optional[Dict[str, float]] = None,
    ) -> None:
        if duration_s <= 0:
            raise ValueError(f"duration_s must be positive: {duration_s}")
        if not 0.0 <= hostile_fraction <= 1.0:
            raise ValueError(
                f"hostile_fraction out of [0,1]: {hostile_fraction}"
            )
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.base_rps = float(base_rps)
        self.diurnal_amplitude = min(max(float(diurnal_amplitude), 0.0), 1.0)
        self.day_length_s = max(float(day_length_s), 1e-6)
        self.flash_crowds = int(flash_crowds)
        self.flash_multiplier = max(1.0, float(flash_multiplier))
        self.flash_duration_s = float(flash_duration_s)
        self.hostile_fraction = float(hostile_fraction)
        self.train_pods = int(train_pods)
        self.train_pod_lifetime_s = float(train_pod_lifetime_s)
        # Serving mix leans interactive: latency classes dominate, batch
        # rides along (matches the FlexNPU-style co-located traffic the
        # paper motivates).
        self.slo_mix = dict(slo_mix or {
            "ttft": 0.45, "tpot": 0.35, "batch": 0.20,
        })
        unknown = set(self.slo_mix) - set(SLO_CLASSES)
        if unknown:
            raise ValueError(f"unknown SLO classes in mix: {sorted(unknown)}")

    # -- rate model --------------------------------------------------------

    def _rate_at(self, t: float, flashes: List[dict]) -> float:
        """Instantaneous arrival rate: diurnal sine around base_rps,
        multiplied inside any flash-crowd window."""
        day = math.sin(2.0 * math.pi * t / self.day_length_s)
        rate = self.base_rps * (1.0 + self.diurnal_amplitude * day)
        for fc in flashes:
            if fc["t"] <= t < fc["t"] + fc["duration_s"]:
                rate *= self.flash_multiplier
        return max(rate, 0.05 * self.base_rps)

    # -- prompt model ------------------------------------------------------

    def _chain_for(self, rng: random.Random, rid: int, hostile: bool):
        """(chain_digests, shared_prefix_len): hostile chains share only
        the root block and diverge immediately (every request a distinct
        path — the affinity table learns nothing it can reuse);
        friendly chains extend one of a small pool of shared prefixes."""
        if hostile:
            root = _digest(self.seed, "hostile-root")
            chain = [root] + [
                _digest(self.seed, "hostile", rid, i)
                for i in range(1, CHAIN_DEPTH)
            ]
            return chain, 1
        family = rng.randrange(FRIENDLY_PREFIX_POOL)
        shared = rng.randint(CHAIN_DEPTH // 2, CHAIN_DEPTH - 1)
        chain = [
            _digest(self.seed, "family", family, i) for i in range(shared)
        ] + [
            _digest(self.seed, "tail", rid, i)
            for i in range(shared, CHAIN_DEPTH)
        ]
        return chain, shared

    def _pick_slo(self, rng: random.Random) -> str:
        x = rng.random() * sum(self.slo_mix.values())
        acc = 0.0
        for slo in SLO_CLASSES:  # fixed iteration order: determinism
            acc += self.slo_mix.get(slo, 0.0)
            if x < acc:
                return slo
        return "batch"

    # -- generation --------------------------------------------------------

    def generate(self) -> Trace:
        rng = random.Random(self.seed)
        events: List[dict] = []

        # Flash-crowd windows first (their placement must not depend on
        # how many arrivals the rate model produced).
        flashes = []
        for i in range(self.flash_crowds):
            start = rng.uniform(
                0.1 * self.duration_s,
                max(0.1 * self.duration_s,
                    self.duration_s - self.flash_duration_s),
            )
            flashes.append({
                "kind": "flash_crowd",
                "t": round(start, 6),
                "duration_s": round(self.flash_duration_s, 6),
                "multiplier": self.flash_multiplier,
                "idx": i,
            })
        events.extend(flashes)

        # Train-tenant churn: admit/delete pairs spread over the trace.
        for i in range(self.train_pods):
            t_admit = rng.uniform(0.0, self.duration_s * 0.6)
            t_del = min(
                t_admit + self.train_pod_lifetime_s
                * rng.uniform(0.7, 1.3),
                self.duration_s,
            )
            name = f"train-{self.seed}-{i}"
            events.append({
                "kind": "pod_admit", "t": round(t_admit, 6),
                "pod": name, "tenancy": "train",
            })
            events.append({
                "kind": "pod_delete", "t": round(t_del, 6),
                "pod": name, "tenancy": "train",
            })

        # Request arrivals: thinned Poisson process against the
        # instantaneous rate (classic Lewis-Shedler), all draws from the
        # single stream.
        peak = (
            self.base_rps * (1.0 + self.diurnal_amplitude)
            * self.flash_multiplier
        )
        t = 0.0
        rid = 0
        while True:
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                break
            if rng.random() >= self._rate_at(t, flashes) / peak:
                continue  # thinned away
            hostile = rng.random() < self.hostile_fraction
            chain, shared = self._chain_for(rng, rid, hostile)
            prompt_tokens = rng.randint(64, 1024)
            events.append({
                "kind": "request",
                "t": round(t, 6),
                "rid": rid,
                "slo": self._pick_slo(rng),
                "tenancy": "serve",
                "hostile": hostile,
                "prompt_tokens": prompt_tokens,
                "output_tokens": rng.randint(8, 256),
                "chain": chain,
                "shared_prefix_blocks": shared,
            })
            rid += 1

        # Stable order: by time, ties broken by kind then id — sorted()
        # is stable and the keys are pure data, so the order is part of
        # the byte-identical contract.
        events.sort(key=lambda e: (
            e["t"], e["kind"], e.get("rid", -1), e.get("pod", ""),
        ))
        meta = {
            "trace_seed": self.seed,
            "duration_s": self.duration_s,
            "base_rps": self.base_rps,
            "diurnal_amplitude": self.diurnal_amplitude,
            "day_length_s": self.day_length_s,
            "flash_crowds": self.flash_crowds,
            "flash_multiplier": self.flash_multiplier,
            "flash_duration_s": self.flash_duration_s,
            "hostile_fraction": self.hostile_fraction,
            "train_pods": self.train_pods,
            "requests": rid,
            "events": len(events),
        }
        return Trace(self.seed, meta, events)


class TraceCursor:
    """Replay pacing: hands out events whose trace-time has come.

    The cursor never reads a clock — the driver (chaos runner, a test
    on ManualClock) calls ``due(now)`` with its own notion of elapsed
    scenario time and dispatches what comes back. Events are consumed
    exactly once, in trace order.
    """

    def __init__(self, trace: Trace) -> None:
        self.trace = trace
        self._i = 0

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.trace.events)

    @property
    def remaining(self) -> int:
        return len(self.trace.events) - self._i

    def due(self, now: float) -> Iterator[dict]:
        """Yield (and consume) every event with ``t <= now``."""
        while (
            self._i < len(self.trace.events)
            and self.trace.events[self._i]["t"] <= now
        ):
            e = self.trace.events[self._i]
            self._i += 1
            yield e

    def drain(self) -> Iterator[dict]:
        """Everything left, regardless of time (end-of-scenario flush)."""
        return self.due(float("inf"))

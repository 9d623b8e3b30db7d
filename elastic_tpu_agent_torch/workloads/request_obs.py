"""Request-level serving observatory, PyTorch port of
``elastic_tpu_agent/workloads/request_obs.py`` (host-side only).

Every admission gets an observatory-minted request id and a gap-free time
partition over a fixed phase vocabulary:

- ``queued``   admission claimed, prefill not started (the chunked-prefill
  queue; ~0 for a synchronous ``admit``);
- ``prefill``  prompt compute, from the first chunk to the first token;
- ``decode``   token generation;
- ``stalled``  live and decoding, but blocked behind another request's
  synchronous prefill on the same engine;
- ``handoff``  published by a prefill-role engine (or by a mid-stream
  handoff), not yet adopted by its peer.

Phases close and open at shared timestamps, so for every finished request
``sum(phase_seconds) + residual == wall`` with residual ~0.

Requests are stitched across a disaggregated pair: the prefill engine
publishes the record through ``SharedKVPool`` under the prompt's block
chain digests (the prefix cache's keys), the decode engine adopts it at
the cache hit that is the handoff, and one id spans both engines.

Per request it also attributes prefix-cache economics (cached vs computed
prefill tokens, the chain digest) and KV-pool bytes; per step it keeps a
bounded breakdown of batch occupancy, admissions vs evictions and the
prefill-vs-decode share. ``bind_metrics`` takes any object with the
agent's ``request_ttft``/``request_tpot``/``request_phase_seconds``
histograms (``labels(...).observe(...)``); ``status()`` is the payload of
the agent's ``/debug/requests``. SLO classes come from a request-carried
annotation; junk values coerce to ``batch`` and are counted, never minted
into label space. Timestamps come from an injected clock
(``elastic_tpu_agent_torch.common``).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Dict, List, Optional

from ..common import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

PHASES = ("queued", "prefill", "decode", "stalled", "handoff")
SLO_CLASSES = ("ttft", "tpot", "batch")
DEFAULT_SLO: str = "batch"

# Per-class latency targets (seconds) used for attainment accounting.
# ``batch`` has no latency target — a batch request attains its SLO by
# finishing at all. Values sit on histogram bucket bounds so fleet-side
# attainment (computed from merged cumulative buckets) agrees with the
# node-side ledger.
DEFAULT_SLO_TARGETS: Dict[str, Dict[str, float]] = {
    "ttft": {"ttft_s": 0.25},
    "tpot": {"tpot_s": 0.05},
    "batch": {},
}

DEFAULT_MAX_FINISHED = 512
DEFAULT_MAX_PENDING_HANDOFF = 256
DEFAULT_STEP_WINDOW = 256
DEFAULT_SAMPLE_WINDOW = 1024


def normalize_slo(slo: Optional[str]) -> str:
    """The effective SLO class for any caller-supplied annotation:
    unknown/absent values coerce to the default — label space is a
    fixed vocabulary, never caller input."""
    return slo if slo in SLO_CLASSES else DEFAULT_SLO


def _quantile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile on a sorted copy (same shape latency.py
    and the goodput ledger use — no interpolation surprises)."""
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, int(round(q * (len(vs) - 1))))
    return vs[idx]


class RequestRecord:
    """One request's partition. Lives in exactly one observatory's
    ``_live`` (or ``_pending_handoff``) set at a time; travels between
    observatories only through SharedKVPool publication."""

    __slots__ = (
        "uid", "slo", "owner", "engine_key", "start_ts", "phase",
        "phase_start", "phase_seconds", "first_token_ts",
        "last_token_ts", "tokens", "cached_tokens", "computed_tokens",
        "prefix_digest", "chain_digests", "kv_blocks", "kv_bytes",
        "finish_ts", "finish_reason", "stitched", "stall_resume",
    )

    def __init__(self, uid: int, slo: str, owner: "RequestObservatory",
                 engine_key: object, now: float) -> None:
        self.uid = uid
        self.slo = slo
        self.owner = owner
        self.engine_key = engine_key
        self.start_ts = now
        self.phase: Optional[str] = None
        self.phase_start = now
        self.phase_seconds: Dict[str, float] = {}
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        self.tokens = 0
        self.cached_tokens = 0
        self.computed_tokens = 0
        self.prefix_digest = ""
        self.chain_digests: tuple = ()
        self.kv_blocks = 0
        self.kv_bytes = 0
        self.finish_ts: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.stitched = False
        self.stall_resume: Optional[str] = None

    # -- partition mechanics ------------------------------------------

    def transition(self, new_phase: Optional[str], now: float) -> None:
        """Close the open phase at ``now`` and open ``new_phase`` at the
        SAME timestamp — the shared boundary is what makes the
        partition gap-free by construction."""
        if self.phase is not None:
            dt = max(0.0, now - self.phase_start)
            self.phase_seconds[self.phase] = (
                self.phase_seconds.get(self.phase, 0.0) + dt
            )
        self.phase = new_phase
        self.phase_start = now

    @property
    def wall_s(self) -> Optional[float]:
        if self.finish_ts is None:
            return None
        return self.finish_ts - self.start_ts

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.start_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-token decode interval; needs >= 2 tokens."""
        if (
            self.first_token_ts is None
            or self.last_token_ts is None
            or self.tokens < 2
        ):
            return None
        return (
            (self.last_token_ts - self.first_token_ts)
            / (self.tokens - 1)
        )

    @property
    def residual_s(self) -> Optional[float]:
        """wall - sum(phases). Defined so the conservation identity
        ``sum(phase_seconds) + residual == wall`` is EXACT; the
        invariant with teeth is that residual itself is ~0 (no gaps),
        which transition() guarantees and tests pin."""
        wall = self.wall_s
        if wall is None:
            return None
        return wall - sum(self.phase_seconds.values())

    def attained(self, targets: Dict[str, Dict[str, float]]) -> bool:
        tgt = targets.get(self.slo, {})
        if "ttft_s" in tgt:
            ttft = self.ttft_s
            return ttft is not None and ttft <= tgt["ttft_s"]
        if "tpot_s" in tgt:
            tpot = self.tpot_s
            # single-token requests have no inter-token interval to
            # miss with
            return tpot is None or tpot <= tgt["tpot_s"]
        return True  # batch: finishing is attaining

    def to_dict(self) -> dict:
        out = {
            "id": self.uid,
            "slo": self.slo,
            "phase": self.phase,
            "phases_ms": {
                k: round(v * 1000, 3)
                for k, v in self.phase_seconds.items()
            },
            "tokens": self.tokens,
            "cached_tokens": self.cached_tokens,
            "computed_tokens": self.computed_tokens,
            "prefix_digest": self.prefix_digest,
            "kv_blocks": self.kv_blocks,
            "kv_bytes": self.kv_bytes,
            "stitched": self.stitched,
        }
        for name, val in (
            ("wall_ms", self.wall_s),
            ("ttft_ms", self.ttft_s),
            ("tpot_ms", self.tpot_s),
            ("residual_ms", self.residual_s),
        ):
            out[name] = (
                round(val * 1000, 3) if val is not None else None
            )
        if self.finish_reason is not None:
            out["finish_reason"] = self.finish_reason
        return out


class RequestObservatory:
    """Per-request SLO ledger for one node's serving engines.

    One observatory serves any number of engines (pass the same
    instance to a disaggregated prefill/decode pair so stitched
    partitions live in one ledger). All timestamps come from the
    injected clock — ManualClock-driven tests control every duration.

    Memory is bounded everywhere: live records by engine slots + queue
    depth, finished records by ``max_finished``, pending handoffs by
    ``max_pending_handoff`` (overflow finishes oldest as
    ``handoff_expired`` — a publication nobody adopts must not leak),
    per-class/per-phase quantile samples and the step ring by fixed
    windows, and histogram labels by the fixed SLO/phase vocabularies.
    """

    def __init__(
        self,
        clock: Clock = SYSTEM_CLOCK,
        metrics=None,
        recorder=None,
        targets: Optional[Dict[str, Dict[str, float]]] = None,
        max_finished: int = DEFAULT_MAX_FINISHED,
        max_pending_handoff: int = DEFAULT_MAX_PENDING_HANDOFF,
        step_window: int = DEFAULT_STEP_WINDOW,
        sample_window: int = DEFAULT_SAMPLE_WINDOW,
    ) -> None:
        self._clock = clock
        self._metrics = metrics
        self.recorder = recorder
        self.targets = dict(DEFAULT_SLO_TARGETS)
        if targets:
            self.targets.update(targets)
        self._next_uid = 0
        self._live: Dict[int, RequestRecord] = {}
        self._pending_handoff: "Dict[int, RequestRecord]" = {}
        self._max_pending_handoff = max_pending_handoff
        self._finished: "deque[RequestRecord]" = deque(
            maxlen=max_finished
        )
        self.finished_total = 0
        self.slo_coerced = 0
        self.stitched_total = 0
        self.handoffs_published = 0
        self.handoffs_adopted = 0
        self.finish_reasons: Dict[str, int] = {}
        # per-class rolling samples for status() quantiles
        self._ttft_samples: Dict[str, deque] = {
            c: deque(maxlen=sample_window) for c in SLO_CLASSES
        }
        self._tpot_samples: Dict[str, deque] = {
            c: deque(maxlen=sample_window) for c in SLO_CLASSES
        }
        self._class_finished: Dict[str, int] = dict.fromkeys(
            SLO_CLASSES, 0
        )
        self._class_attained: Dict[str, int] = dict.fromkeys(
            SLO_CLASSES, 0
        )
        self._phase_samples: Dict[str, deque] = {
            p: deque(maxlen=sample_window) for p in PHASES
        }
        self._phase_totals: Dict[str, float] = dict.fromkeys(
            PHASES, 0.0
        )
        self._worst_residual_s = 0.0
        # per-engine stall nesting depth
        self._stall_depth: Dict[object, int] = {}
        # bounded per-step engine breakdown
        self._steps: "deque[dict]" = deque(maxlen=step_window)
        self.steps_total = 0
        self._step_acc = {
            "emitted_tokens": 0, "activated": 0, "evicted": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "occupancy_sum": 0.0,
        }

    # -- wiring -------------------------------------------------------

    def bind_metrics(self, metrics) -> None:
        """Called by AgentMetrics.attach_requests: histograms are
        observed at source, gauges read at scrape."""
        self._metrics = metrics

    @property
    def clock(self) -> Clock:
        return self._clock

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def pending_handoff_count(self) -> int:
        return len(self._pending_handoff)

    # -- engine-facing lifecycle --------------------------------------

    def admit(self, engine_key: object, slo: Optional[str] = None) -> int:
        """A claim succeeded: mint an id, open the partition in
        ``queued``. Junk SLO annotations coerce to the default class —
        label space never grows with caller input."""
        if slo is None:
            slo = DEFAULT_SLO
        elif slo not in SLO_CLASSES:
            self.slo_coerced += 1
            slo = DEFAULT_SLO
        uid = self._next_uid
        self._next_uid += 1
        rec = RequestRecord(
            uid, slo, self, engine_key, self._clock.monotonic()
        )
        rec.transition("queued", rec.start_ts)
        self._live[uid] = rec
        return uid

    def prefill_start(self, uid: int) -> None:
        rec = self._live.get(uid)
        if rec is None or rec.phase == "prefill":
            return
        rec.transition("prefill", self._clock.monotonic())

    def prefill_done(
        self,
        uid: int,
        cached_tokens: int = 0,
        computed_tokens: int = 0,
        prefix_digest: str = "",
        chain_digests: tuple = (),
        kv_blocks: int = 0,
        kv_bytes: int = 0,
    ) -> None:
        """Attribution only (no phase change): cached vs computed
        prefill tokens and the block-chain digest. Accumulates, so a
        stitched request sums both roles' contributions."""
        rec = self._live.get(uid)
        if rec is None:
            return
        rec.cached_tokens += int(cached_tokens)
        rec.computed_tokens += int(computed_tokens)
        if prefix_digest:
            rec.prefix_digest = prefix_digest
        if chain_digests:
            rec.chain_digests = tuple(chain_digests)
        if kv_blocks:
            rec.kv_blocks = int(kv_blocks)
            rec.kv_bytes = int(kv_bytes)

    def first_token(self, uid: int) -> None:
        """Prefill produced the first emitted token: enter decode and
        stamp TTFT. For a stitched request this fires on the DECODE
        side, so TTFT spans prefill + handoff + tail prefill — the
        latency the client actually saw."""
        rec = self._live.get(uid)
        if rec is None:
            return
        now = self._clock.monotonic()
        rec.first_token_ts = now
        rec.last_token_ts = now
        rec.tokens = max(rec.tokens, 1)
        rec.transition("decode", now)
        depth = self._stall_depth.get(rec.engine_key, 0)
        if depth > 0:
            # born inside a stall window (its own synchronous prefill):
            # it decodes only once the window closes
            rec.stall_resume = "decode"
            rec.transition("stalled", now)

    def tokens_emitted(self, uid: int, n: int) -> None:
        rec = self._live.get(uid)
        if rec is None or n <= 0:
            return
        rec.tokens += int(n)
        rec.last_token_ts = self._clock.monotonic()

    # -- stall windows (unified-mode head-of-line) --------------------

    def stall_begin(self, engine_key: object) -> None:
        """A synchronous prefill is about to block this engine: every
        live decoding request on it stops making progress — attribute
        that time to ``stalled``, not ``decode``."""
        depth = self._stall_depth.get(engine_key, 0)
        self._stall_depth[engine_key] = depth + 1
        if depth > 0:
            return
        now = self._clock.monotonic()
        for rec in self._live.values():
            if rec.engine_key == engine_key and rec.phase == "decode":
                rec.stall_resume = "decode"
                rec.transition("stalled", now)

    def stall_end(self, engine_key: object) -> None:
        depth = self._stall_depth.get(engine_key, 0)
        if depth <= 0:
            return
        self._stall_depth[engine_key] = depth - 1
        if depth > 1:
            return
        now = self._clock.monotonic()
        for rec in self._live.values():
            if (
                rec.engine_key == engine_key
                and rec.phase == "stalled"
                and rec.stall_resume
            ):
                rec.transition(rec.stall_resume, now)
                rec.stall_resume = None

    # -- disaggregated stitching --------------------------------------

    def handoff_begin(self, uid: int) -> Optional[RequestRecord]:
        """Prefill role finished its half: the partition stays OPEN in
        ``handoff`` awaiting adoption. Returns the record for the
        engine to publish through SharedKVPool."""
        rec = self._live.pop(uid, None)
        if rec is None:
            return None
        rec.transition("handoff", self._clock.monotonic())
        self._pending_handoff[uid] = rec
        self.handoffs_published += 1
        while len(self._pending_handoff) > self._max_pending_handoff:
            # a publication nobody adopted: close it out rather than
            # leak an open partition forever
            stale_uid = next(iter(self._pending_handoff))
            self.finish(stale_uid, "handoff_expired")
        return rec

    def adopt(self, rec: RequestRecord, engine_key: object) -> int:
        """Decode role adopted a published record at the auto-cache
        hit: close the handoff phase, continue the SAME partition here.
        Works across observatory instances (the record migrates to the
        adopting ledger)."""
        rec.owner._pending_handoff.pop(rec.uid, None)
        rec.owner = self
        rec.engine_key = engine_key
        rec.stitched = True
        rec.transition("prefill", self._clock.monotonic())
        if rec.uid in self._live:  # defensive: uid collision across
            rec.uid = self._next_uid  # observatories — remint
            self._next_uid += 1
        self._next_uid = max(self._next_uid, rec.uid + 1)
        self._live[rec.uid] = rec
        self.handoffs_adopted += 1
        self.stitched_total += 1
        return rec.uid

    # -- finish -------------------------------------------------------

    def finish(
        self,
        uid: int,
        reason: str = "released",
        kv_blocks: Optional[int] = None,
        kv_bytes: Optional[int] = None,
    ) -> Optional[RequestRecord]:
        """Close the partition — the single exit for every path
        (release, stop token, max_len, pool eviction, drain, handoff
        expiry). Observes histograms, records ``request_finish``,
        rolls the record into the bounded ledgers."""
        rec = self._live.pop(uid, None)
        if rec is None:
            rec = self._pending_handoff.pop(uid, None)
        if rec is None:
            return None
        now = self._clock.monotonic()
        rec.transition(None, now)
        rec.finish_ts = now
        rec.finish_reason = reason
        if kv_blocks is not None:
            rec.kv_blocks = int(kv_blocks)
        if kv_bytes is not None:
            rec.kv_bytes = int(kv_bytes)
        self._finished.append(rec)
        self.finished_total += 1
        self.finish_reasons[reason] = (
            self.finish_reasons.get(reason, 0) + 1
        )
        residual = rec.residual_s or 0.0
        if abs(residual) > abs(self._worst_residual_s):
            self._worst_residual_s = residual
        ttft = rec.ttft_s
        tpot = rec.tpot_s
        self._class_finished[rec.slo] += 1
        if rec.attained(self.targets):
            self._class_attained[rec.slo] += 1
        if ttft is not None:
            self._ttft_samples[rec.slo].append(ttft)
        if tpot is not None:
            self._tpot_samples[rec.slo].append(tpot)
        for phase, secs in rec.phase_seconds.items():
            if phase in self._phase_samples:
                self._phase_samples[phase].append(secs)
                self._phase_totals[phase] += secs
        self._observe_metrics(rec, ttft, tpot)
        self._record_finish(rec, ttft, tpot)
        return rec

    def _observe_metrics(self, rec, ttft, tpot) -> None:
        m = self._metrics
        if m is None:
            return
        try:
            if ttft is not None:
                m.request_ttft.labels(slo=rec.slo).observe(ttft)
            if tpot is not None:
                m.request_tpot.labels(slo=rec.slo).observe(tpot)
            for phase, secs in rec.phase_seconds.items():
                m.request_phase_seconds.labels(
                    phase=phase
                ).observe(secs)
        except Exception:  # noqa: BLE001 - metrics never break serving
            logger.debug("request metrics observe failed", exc_info=True)

    def _record_finish(self, rec, ttft, tpot) -> None:
        if self.recorder is None:
            return
        try:
            self.recorder.record(
                "request_finish",
                request_id=rec.uid,
                slo=rec.slo,
                reason=rec.finish_reason,
                wall_ms=round((rec.wall_s or 0.0) * 1000, 3),
                ttft_ms=(
                    round(ttft * 1000, 3) if ttft is not None else None
                ),
                tpot_ms=(
                    round(tpot * 1000, 3) if tpot is not None else None
                ),
                tokens=rec.tokens,
                cached_tokens=rec.cached_tokens,
                computed_tokens=rec.computed_tokens,
                prefix_digest=rec.prefix_digest,
                kv_bytes=rec.kv_bytes,
                stitched=rec.stitched,
                phases_ms={
                    k: round(v * 1000, 3)
                    for k, v in rec.phase_seconds.items()
                },
            )
        except Exception:  # noqa: BLE001 - telemetry, best-effort
            logger.debug("request_finish record failed", exc_info=True)

    # -- per-step engine breakdown ------------------------------------

    def step(
        self,
        engine_key: object,
        live: int = 0,
        slots: int = 0,
        pending: int = 0,
        activated: int = 0,
        evicted: int = 0,
        emitted_tokens: int = 0,
        prefill_s: float = 0.0,
        decode_s: float = 0.0,
    ) -> None:
        occupancy = (live / slots) if slots else 0.0
        self._steps.append({
            "engine": str(engine_key),
            "live": live,
            "slots": slots,
            "pending": pending,
            "occupancy": round(occupancy, 4),
            "activated": activated,
            "evicted": evicted,
            "emitted_tokens": emitted_tokens,
            "prefill_ms": round(prefill_s * 1000, 3),
            "decode_ms": round(decode_s * 1000, 3),
        })
        self.steps_total += 1
        acc = self._step_acc
        acc["emitted_tokens"] += emitted_tokens
        acc["activated"] += activated
        acc["evicted"] += evicted
        acc["prefill_s"] += prefill_s
        acc["decode_s"] += decode_s
        acc["occupancy_sum"] += occupancy

    # -- reading ------------------------------------------------------

    def attainment(self, slo: str) -> Optional[float]:
        n = self._class_finished.get(slo, 0)
        if not n:
            return None
        return self._class_attained[slo] / n

    def status(
        self,
        request_id: Optional[int] = None,
        slo: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> dict:
        classes = {}
        for c in SLO_CLASSES:
            n = self._class_finished[c]
            if not n and not self._ttft_samples[c]:
                continue
            att = self.attainment(c)
            classes[c] = {
                "finished": n,
                "attained": self._class_attained[c],
                "attainment": (
                    round(att, 4) if att is not None else None
                ),
                "ttft_p50_ms": _ms(
                    _quantile(list(self._ttft_samples[c]), 0.5)
                ),
                "ttft_p99_ms": _ms(
                    _quantile(list(self._ttft_samples[c]), 0.99)
                ),
                "tpot_p50_ms": _ms(
                    _quantile(list(self._tpot_samples[c]), 0.5)
                ),
                "tpot_p99_ms": _ms(
                    _quantile(list(self._tpot_samples[c]), 0.99)
                ),
            }
        phase_total = sum(self._phase_totals.values())
        phases = {}
        for p in PHASES:
            samples = list(self._phase_samples[p])
            if not samples:
                continue
            phases[p] = {
                "count": len(samples),
                "p50_ms": _ms(_quantile(samples, 0.5)),
                "p99_ms": _ms(_quantile(samples, 0.99)),
                "share": (
                    round(self._phase_totals[p] / phase_total, 4)
                    if phase_total > 0 else 0.0
                ),
            }
        acc = self._step_acc
        compute = acc["prefill_s"] + acc["decode_s"]
        steps = {
            "count": self.steps_total,
            "occupancy_mean": (
                round(acc["occupancy_sum"] / self.steps_total, 4)
                if self.steps_total else None
            ),
            "admissions": acc["activated"],
            "evictions": acc["evicted"],
            "emitted_tokens": acc["emitted_tokens"],
            "prefill_share": (
                round(acc["prefill_s"] / compute, 4)
                if compute > 0 else None
            ),
            "decode_share": (
                round(acc["decode_s"] / compute, 4)
                if compute > 0 else None
            ),
            "recent": list(self._steps)[-8:],
        }
        recent: List[dict] = []
        pool = list(self._finished)[::-1]  # newest first
        live = [
            r for r in list(self._live.values())
            + list(self._pending_handoff.values())
        ]
        for rec in live + pool:
            if request_id is not None and rec.uid != request_id:
                continue
            if slo is not None and rec.slo != slo:
                continue
            recent.append(rec.to_dict())
            if limit is not None and len(recent) >= limit:
                break
        out = {
            "requests_total": self._next_uid,
            "live": len(self._live),
            "pending_handoff": len(self._pending_handoff),
            "finished": self.finished_total,
            "stitched": self.stitched_total,
            "handoffs_published": self.handoffs_published,
            "handoffs_adopted": self.handoffs_adopted,
            "slo_coerced": self.slo_coerced,
            "finish_reasons": dict(self.finish_reasons),
            "targets": {
                c: dict(t) for c, t in self.targets.items()
            },
            "classes": classes,
            "phases": phases,
            "conservation": {
                "checked": self.finished_total,
                "worst_residual_ms": round(
                    self._worst_residual_s * 1000, 6
                ),
            },
            "steps": steps,
            "requests": recent,
        }
        if self.recorder is not None and self.recorder.trace_id:
            out["trace_id"] = self.recorder.trace_id
        return out


def _ms(seconds: Optional[float]) -> Optional[float]:
    return round(seconds * 1000, 3) if seconds is not None else None

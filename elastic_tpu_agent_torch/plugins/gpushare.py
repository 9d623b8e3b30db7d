"""gpushare: fractional GPU core and memory device plugins.

Counterpart of ``elastic_tpu_agent/plugins/tpushare.py`` and of the
reference's ``pkg/plugins/gpushare.go``:

- ``elasticgpu.io/gpu-core``: 100 fake devices a card (1% steps);
- ``elasticgpu.io/gpu-memory``: one fake device a MiB of the card's memory.

The elastic scheduler has annotated the pod with the cards it chose.
PreStartContainer finds the requesting pod through the locator, reads the
annotation, makes the virtual links, records the binding and writes the
allocation spec that the container's injection reads.

Device nodes. NVIDIA's user-space driver opens ``/dev/nvidia<minor>`` by the
minor the kernel driver reports, so a card's node keeps its host name in
the container (the agent's dense ``/dev/accel<p>`` renumbering would never
be found), beside the control nodes every CUDA process opens
(``/dev/nvidiactl``, ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``:
``GPUChip.extra_paths``).

- Whole-card mode (``device.ExclusiveOperator``): the ids name the cards,
  so Allocate hands out each card's node and the control nodes, with
  ``CUDA_VISIBLE_DEVICES`` naming the cards by uuid. A plain kubelet is
  enough.
- Shared mode: the card is known only at PreStart, from the scheduler's
  annotation. Allocate gives the allocation hash, the quota env and the
  control nodes; PreStart writes a spec naming the bound cards' nodes and
  their ``CUDA_VISIBLE_DEVICES``, and the injection (``nri/plugin.py``)
  adds both at container create, cgroup rules included. A shared pod run
  without the injection gets no card.

The allocation logic (ids, card choice, envs, device specs, bind, spec)
imports neither ``grpc`` nor protobuf: it runs where neither is installed.
The five kubelet RPCs wrap it and import the v1beta1 messages when called.
Nothing here imports torch: the agent's process holds no CUDA context.

The bind runs under the agent's tracer and fault points: PreStart opens a
trace whose id the spec env carries (``ELASTIC_TPU_TRACE_ID``), and the
``bind.*`` points name the crash windows the reconciler recovers. The
bundle runs the supervised health and GC loops and serves the reconciler
(``rebind``, ``plugin_for_resource``, ``bind_lock``: the stripes one
container's core and memory binds share, which the reconciler takes
around a pod).

The observability seams are the agent's, each optional and never
load-bearing: the timeline journals bind_intent, bind_commit,
bind_rollback and bind_replay, card-health flips and GC reclaims; the
Event recorder posts TPUBound / TPUBindFailed on the pod and
TPUReclaimed and card-health Events on the node; the CRD recorder
publishes Bound and Released objects and flips inventory objects on
health changes; AgentMetrics takes the Allocate and PreStart latencies,
the in-flight binds, the bind-lock wait, the bound allocations, the
healthy cards and GC's reclaims. GC also reports each reclaim's lag from
the sitter's deletion mark to the detection-lag tracker, with trigger
``event`` when a queued deletion woke it and ``poll`` on its periodic
tick.

The bundle's ``on_chips_failed``/``on_chips_recovered`` hooks are the
agent's: the manager points them at the NRI server's eviction under
``--nri-evict-on-chip-failure``. The health poll folds in the utilization
sampler's flags (``PluginConfig.sampler``); the drain cordons both
resources through ``set_cordoned``; ``restamp_spec_env_locked`` is the one
path by which the drain's signal, the pre-copy cutover and the restore
stamp reach a running pod's specs (``plugins.restamp_owner_env`` takes the
owner's stripe around it).

Not ported in this slice: the slice env, the ICI packing histogram and
the repartition controller's quota restamps.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .. import faults
from ..common import (
    HEALTHY,
    UNHEALTHY,
    AllocSidecarSubdirs,
    AnnotationAssumed,
    AnnotationTraceID,
    BytesPerMemoryUnit,
    EnvAllocationHash,
    GPUPercentEachCard,
    ResourceGPUCore,
    ResourceGPUMemory,
    StripedLockSet,
    container_annotation,
)
from .. import timeline as tl
from ..device.qos import qos_env, visibility_env
from ..kube.events import (
    ReasonBindFailed,
    ReasonBound,
    ReasonChipHealthy,
    ReasonChipUnhealthy,
    ReasonReclaimed,
)
from ..slices import packing
from ..tracing import get_tracer
from ..types import AllocationRecord, Device, PodContainer
from .base import DevicePluginServer, LocateError, PluginConfig

logger = logging.getLogger(__name__)

CORE_ENDPOINT = "elastic-gpushare-core.sock"
MEM_ENDPOINT = "elastic-gpushare-mem.sock"

# Where allocation specs live, as the agent sees them (host path
# /var/lib/elastic-tpu/alloc, hostPath-mounted)
DEFAULT_ALLOC_SPEC_DIR = "/host/var/lib/elastic-tpu/alloc"

GC_PERIOD_S = 60.0  # the reference's GC tick (base.go:248)
HEALTH_PERIOD_S = 5.0

# Striped per-owner locks serializing the alloc-spec writes of the core and
# memory plugins and the reconciler's repairs: the two PreStarts of one
# container share a pod key, hence a stripe, while unrelated pods bind in
# parallel. One set for the process, as the agent's.
BIND_LOCK_STRIPES = 256
_BIND_LOCKS = StripedLockSet(BIND_LOCK_STRIPES)


def bind_lock(pod_key: str):
    """Context manager holding the owner's bind stripe: the reconciler
    serializes its intent rollback and drift repair against live binds
    with the lock the bind itself takes. Not reentrant: while holding it,
    call the ``_locked`` variants (``remove_alloc_spec_locked``), never
    the methods that take the stripe themselves."""
    return _BIND_LOCKS.acquire(pod_key)


def _write_json_atomic(path: str, payload: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _merge_spec_payloads(a: Dict, b: Dict) -> Tuple[Dict, Dict]:
    """Union two alloc-spec payloads of one container; returns both with
    the same devices, control nodes and env (each keeps its own hash and
    resource). On a
    shared env key the gpu-core payload's value wins (the quota keys never
    collide; ``CUDA_VISIBLE_DEVICES`` agrees, both plugins reading one
    annotation)."""
    chip_to_path: Dict[int, str] = {}
    for p in (a, b):
        for c, d in zip(p.get("chip_indexes", []), p.get("device_paths", [])):
            chip_to_path[c] = d
    chips = sorted(chip_to_path)
    control = list(dict.fromkeys(
        a.get("control_paths", []) + b.get("control_paths", [])))
    env: Dict[str, str] = {}
    # core last -> core wins ties
    first, second = (b, a) if a.get("resource") == ResourceGPUCore else (a, b)
    env.update(first.get("env", {}))
    env.update(second.get("env", {}))
    resources = sorted(
        {a.get("resource", ""), b.get("resource", "")}
        | set(a.get("resources", []))
        | set(b.get("resources", []))
    )
    out = []
    for p in (a, b):
        m = dict(p)
        m["chip_indexes"] = chips
        m["device_paths"] = [chip_to_path[c] for c in chips]
        m["control_paths"] = control
        m["env"] = env
        m["resources"] = resources
        out.append(m)
    return out[0], out[1]


def core_device_id(chip: int, unit: int) -> str:
    return f"gpu-core-{chip}-{unit}"


def mem_device_id(chip: int, unit: int) -> str:
    return f"gpu-mem-{chip}-{unit}"


def chip_of_device_id(device_id: str) -> Optional[int]:
    parts = device_id.split("-")
    try:
        return int(parts[2])
    except (IndexError, ValueError):
        return None


def _parse_chip_annotation(value: str) -> List[int]:
    """"0" or "0,1" -> [0, 1] (reference gpushare.go:103-112)."""
    return [int(part) for part in (p.strip() for p in value.split(","))
            if part]


@dataclass(frozen=True)
class DeviceSpec:
    """A device node handed to the kubelet (v1beta1 ``DeviceSpec``)."""

    container_path: str
    host_path: str
    permissions: str = "rwm"


@dataclass
class ContainerAllocation:
    """One container's Allocate answer (v1beta1
    ``ContainerAllocateResponse``): its env and device nodes."""

    envs: Dict[str, str] = field(default_factory=dict)
    devices: List[DeviceSpec] = field(default_factory=list)


class _ListAndWatchMixin:
    """ListAndWatch: the initial list, then a resend on each notify whose
    (id, health) list differs from the last one sent."""

    def __init__(self) -> None:
        self._law_cond = threading.Condition()
        self._law_version = 0
        self._stopped = False

    def notify_devices_changed(self) -> None:
        with self._law_cond:
            self._law_version += 1
            self._law_cond.notify_all()

    def stop_streams(self) -> None:
        with self._law_cond:
            self._stopped = True
            self._law_cond.notify_all()

    def device_list(self) -> List[Tuple[str, str]]:
        """Every advertised (device id, health)."""
        raise NotImplementedError

    def ListAndWatch(self, request, context):  # noqa: N802, ARG002
        from ..gen import deviceplugin_pb2 as dp

        version = -1
        sent = None
        while True:
            with self._law_cond:
                while self._law_version == version and not self._stopped:
                    self._law_cond.wait(timeout=5.0)
                    if not context.is_active():
                        return
                if self._stopped:
                    return
                version = self._law_version
            devices = self.device_list()
            if devices == sent:
                # an A -> B -> A flip settled before this stream caught up
                continue
            sent = devices
            yield dp.ListAndWatchResponse(devices=[
                dp.Device(ID=i, health=h) for i, h in devices])


class _GPUSharePluginBase(_ListAndWatchMixin):
    """The Allocate/PreStart skeleton shared by the core and memory
    plugins, and the five kubelet RPCs (the servicer of
    ``rpc.add_device_plugin_servicer``)."""

    resource: str = ""

    def __init__(self, config: PluginConfig) -> None:
        _ListAndWatchMixin.__init__(self)
        self._config = config
        self._operator = config.operator
        self._sitter = config.sitter
        self._storage = config.storage
        self._locator = config.locator_factory(self.resource)
        self._chips = {c.index: c for c in self._operator.devices()}
        # whole-card (exclusive) mode: the operator makes no virtual nodes
        self._whole_chip = not getattr(self._operator, "virtual_nodes", True)
        # every card's control nodes, once each, in discovery order
        self._control_paths = list(dict.fromkeys(
            p for c in self._chips.values() for p in c.extra_paths))
        self._unhealthy_chips: set = set()
        # drain cordon: every device advertised Unhealthy, so that the
        # kubelet stops new placements, without counting any card unhealthy
        self._cordoned = False
        self._alloc_dir = config.extra.get(
            "alloc_spec_dir", DEFAULT_ALLOC_SPEC_DIR
        )
        self._metrics = config.metrics
        self._crd = config.crd_recorder
        self._events = config.events
        self._timeline = config.timeline
        self._bind_count_lock = threading.Lock()
        self._bind_counts = {"inflight": 0, "binds_total": 0,
                             "bind_failures_total": 0}

    # -- health ---------------------------------------------------------------

    def unhealthy_chips(self) -> set:
        """Card indexes advertised Unhealthy to the kubelet."""
        return set(self._unhealthy_chips)

    def _chip_health(self, chip_index: int) -> str:
        return (
            UNHEALTHY
            if self._cordoned or chip_index in self._unhealthy_chips
            else HEALTHY
        )

    @property
    def cordoned(self) -> bool:
        return self._cordoned

    def set_cordoned(self, flag: bool) -> None:
        """Flip the drain cordon and wake ListAndWatch; health accounting
        is untouched. Idempotent."""
        flag = bool(flag)
        if flag == self._cordoned:
            return
        self._cordoned = flag
        logger.warning(
            "%s: devices %s by drain cordon", self.resource,
            "unschedulable" if flag else "re-schedulable",
        )
        self.notify_devices_changed()

    def apply_health(self, healthy: set) -> tuple:
        """Apply an operator health view; on a change, flip device health
        and wake ListAndWatch. Returns the (went_bad, recovered) sets."""
        unhealthy = set(self._chips) - healthy
        if unhealthy == self._unhealthy_chips:
            return set(), set()
        went_bad = unhealthy - self._unhealthy_chips
        recovered = self._unhealthy_chips - unhealthy
        self._unhealthy_chips = unhealthy
        if went_bad:
            logger.warning(
                "%s: cards %s now unhealthy", self.resource, sorted(went_bad)
            )
        if recovered:
            logger.info(
                "%s: cards %s recovered", self.resource, sorted(recovered)
            )
        self.notify_devices_changed()
        return went_bad, recovered

    # -- Allocate -------------------------------------------------------------

    def _qos_kwargs(self, device: Device) -> Dict:
        """Per-resource inputs of qos_env (overridden by subclasses)."""
        return {}

    def _alloc_envs(self, device: Device) -> Dict[str, str]:
        # qos_env reads _qos_kwargs, as the spec does, so the Allocate env
        # and the injected env never disagree
        envs = {EnvAllocationHash: device.hash}
        envs.update(qos_env({}, **self._qos_kwargs(device)))
        return envs

    def _alloc_device_specs(self, device: Device) -> List[DeviceSpec]:
        return []

    def allocate_container(self, ids: Iterable[str]) -> ContainerAllocation:
        """Allocate for one container's fake device ids."""
        t0 = time.monotonic()
        device = Device(ids, self.resource)
        with get_tracer().trace("Allocate", resource=self.resource,
                                hash=device.hash, n_ids=len(device.ids),
                                node=self._config.node_name) as tr:
            with get_tracer().span("build_response", hash=device.hash):
                alloc = ContainerAllocation(
                    envs=self._alloc_envs(device),
                    devices=self._alloc_device_specs(device))
            logger.info("Allocate %s: %d ids -> hash %s [trace %s]",
                        self.resource, len(device.ids), device.hash,
                        tr.trace_id)
            if self._metrics is not None:
                self._metrics.observe_allocate(time.monotonic() - t0)
        return alloc

    def GetDevicePluginOptions(self, request, context):  # noqa: N802, ARG002
        from ..gen import deviceplugin_pb2 as dp

        return dp.DevicePluginOptions(
            pre_start_required=True,
            get_preferred_allocation_available=True,
        )

    def Allocate(self, request, context):  # noqa: N802, ARG002
        from ..gen import deviceplugin_pb2 as dp

        responses = []
        for creq in request.container_requests:
            alloc = self.allocate_container(creq.devicesIDs)
            responses.append(dp.ContainerAllocateResponse(
                envs=alloc.envs,
                devices=[dp.DeviceSpec(container_path=d.container_path,
                                       host_path=d.host_path,
                                       permissions=d.permissions)
                         for d in alloc.devices],
            ))
        # warm the locate cache while the kubelet starts the pod
        if hasattr(self._locator, "prefetch_async"):
            self._locator.prefetch_async()
        return dp.AllocateResponse(container_responses=responses)

    # -- GetPreferredAllocation ----------------------------------------------

    def preferred_ids(self, available: Iterable[str],
                      must_include: Iterable[str], size: int) -> List[str]:
        """The ids to propose for a request of ``size``: the must-include
        ids, then free ids drawn from the cards ``packing.pick_chip_set``
        chooses, so that a fractional grant stays on one card (the
        reference returned nothing, base.go:86-88, and the kubelet
        scattered ids across cards)."""
        chosen = list(must_include)
        need = size - len(chosen)
        if need <= 0:
            return chosen
        taken = set(chosen)
        by_chip: Dict[int, List[str]] = {}
        unparseable: List[str] = []
        for did in available:
            if did in taken:
                continue
            chip = chip_of_device_id(did)
            if chip is None:
                # last-resort filler only, never bucketed onto a card
                unparseable.append(did)
                continue
            by_chip.setdefault(chip, []).append(did)
        pinned = {c for c in map(chip_of_device_id, chosen) if c is not None}
        for chip in packing.pick_chip_set(by_chip, need, pinned):
            take = by_chip[chip][:need]
            chosen.extend(take)
            need -= len(take)
            if need <= 0:
                break
        if need > 0:
            chosen.extend(unparseable[:need])
        return chosen

    def GetPreferredAllocation(self, request, context):  # noqa: N802, ARG002
        from ..gen import deviceplugin_pb2 as dp

        return dp.PreferredAllocationResponse(container_responses=[
            dp.ContainerPreferredAllocationResponse(deviceIDs=self.preferred_ids(
                creq.available_deviceIDs, creq.must_include_deviceIDs,
                creq.allocation_size))
            for creq in request.container_requests
        ])

    # -- PreStartContainer ----------------------------------------------------

    def pre_start(self, ids: Iterable[str]) -> None:
        """Bind one container's fake device ids (PreStartContainer), under
        a trace whose id the spec env carries."""
        t0 = time.monotonic()
        device = Device(ids, self.resource)
        if self._metrics is not None:
            self._metrics.bind_inflight.inc()
        self._count_bind("inflight", 1)
        with get_tracer().trace(
            "PreStartContainer", resource=self.resource, hash=device.hash,
            n_ids=len(device.ids), node=self._config.node_name,
        ) as tr:
            try:
                self._bind(device)
            except Exception:
                self._count_bind("bind_failures_total", 1)
                logger.exception("PreStartContainer %s failed for %s "
                                 "[trace %s]", self.resource, device.hash,
                                 tr.trace_id)
                raise
            finally:
                self._count_bind("inflight", -1)
                self._count_bind("binds_total", 1)
                if self._metrics is not None:
                    self._metrics.bind_inflight.dec()
                    self._metrics.observe_prestart(time.monotonic() - t0)

    def _count_bind(self, key: str, delta: int) -> None:
        with self._bind_count_lock:
            self._bind_counts[key] += delta

    def PreStartContainer(self, request, context):  # noqa: N802, ARG002
        from ..gen import deviceplugin_pb2 as dp

        self.pre_start(request.devicesIDs)
        return dp.PreStartContainerResponse()

    def _lookup_pod(self, owner) -> Optional[dict]:
        with get_tracer().span(
            "pod_lookup", pod=f"{owner.namespace}/{owner.name}"
        ) as sp:
            pod = self._sitter.get_pod(owner.namespace, owner.name)
            sp.set(informer_hit=pod is not None)
            if pod is None:
                pod = self._sitter.get_pod_from_api(owner.namespace,
                                                    owner.name)
        return pod

    def _bind(self, device: Device) -> None:
        owner = self._locator.locate(device)
        pod = self._lookup_pod(owner)
        if pod is None and hasattr(self._locator, "invalidate"):
            # the locator's cache may hold a dead owner for a reused id set
            # (the kubelet recycles ids once the old pod is gone): list
            # afresh and retry once
            self._locator.invalidate()
            owner = self._locator.locate(device)
            pod = self._lookup_pod(owner)
        if pod is None:
            raise LocateError(f"pod {owner.pod_key} not found anywhere")
        # from here the trace is attributable to a pod
        get_tracer().annotate(
            pod=f"{owner.namespace}/{owner.name}", container=owner.container)
        # an admission-stamped trace id: the bind continues under it (the
        # core and the memory bind of a container adopt the same id)
        admission_id = (
            pod.get("metadata", {}).get("annotations", {}) or {}
        ).get(AnnotationTraceID, "")
        if admission_id:
            get_tracer().adopt_id(admission_id)
        try:
            self._bind_located(device, owner, pod)
        except Exception as e:
            if self._events is not None:
                self._events.pod_event(
                    owner.namespace, owner.name, ReasonBindFailed,
                    f"{self.resource} {device.hash}: {e}", type_="Warning",
                    uid=pod.get("metadata", {}).get("uid", ""),
                )
            raise

    def _chips_from_ids(self, device: Device) -> List[int]:
        """Card indexes encoded in the fake ids: the placement in
        whole-card mode, where no annotation redirects it."""
        return sorted({c for c in map(chip_of_device_id, device.ids)
                       if c is not None})

    def _known_chips_from_ids(self, device: Device) -> List[int]:
        return [c for c in self._chips_from_ids(device) if c in self._chips]

    def _journal_intent(self, owner, device: Device,
                        chip_indexes: List[int], planned: List[str]) -> int:
        """Write-ahead intent: what recovery needs to roll this bind back
        (the link ids it will make) or replay it (the ids), durable before
        the first side effect."""
        intent_id = self._storage.journal_intent(
            owner.pod_key, owner.container, self.resource, device.hash,
            {
                "device_ids": list(device.ids),
                "chip_indexes": list(chip_indexes),
                "planned_link_ids": list(planned),
            },
        )
        if self._timeline is not None:
            self._timeline.emit(
                tl.KIND_BIND_INTENT,
                keys=self._bind_keys(owner, device, chip_indexes),
                resource=self.resource, intent_id=intent_id,
                n_ids=len(device.ids),
            )
        return intent_id

    @staticmethod
    def _bind_keys(owner, device: Device, chip_indexes: List[int]) -> Dict:
        return {
            "pod": owner.pod_key,
            "container": owner.container,
            "hash": device.hash,
            "chips": list(chip_indexes),
        }

    def _emit_rollback(self, owner, device: Device, chip_indexes: List[int],
                       intent_id: int, reason: str) -> None:
        if self._timeline is not None:
            self._timeline.emit(
                tl.KIND_BIND_ROLLBACK,
                keys=self._bind_keys(owner, device, chip_indexes),
                resource=self.resource, intent_id=intent_id, reason=reason,
            )

    def _bind_located(self, device: Device, owner, pod: dict) -> None:
        annotations = pod.get("metadata", {}).get("annotations", {}) or {}
        # crash-window failpoints (test-only): each names the window a
        # process death is injected into, proving the journal recovers it
        faults.fire("bind.pre_journal")
        if self._whole_chip:
            # the kubelet's device choice is the placement; no annotation
            # is required and no link is made: Allocate handed out the
            # cards' own nodes
            chip_indexes = self._chips_from_ids(device)
            self._require_known_chips(chip_indexes)
            intent_id = self._journal_intent(owner, device, chip_indexes, [])
            try:
                faults.fire("bind.post_journal")
                try:
                    self._finish_bind(device, owner, pod, annotations,
                                      chip_indexes, created=[],
                                      intent_id=intent_id)
                except Exception:
                    # rolled back: the intent must not linger
                    self._storage.journal_remove(intent_id)
                    self._emit_rollback(owner, device, chip_indexes,
                                        intent_id, "handled_failure")
                    raise
            finally:
                # on every exit this thread stops shielding the intent
                self._storage.intent_done(intent_id)
            return
        if annotations.get(AnnotationAssumed) != "true":
            raise LocateError(
                f"pod {owner.pod_key} not assumed by the elastic scheduler"
            )
        ann_key = container_annotation(owner.container)
        if ann_key not in annotations:
            raise LocateError(
                f"pod {owner.pod_key} missing annotation {ann_key}"
            )
        # every card of a shared pod comes through the injection (Allocate
        # names none), so a scheduler that spreads the pod over more cards
        # than Allocate's minimum loses nothing
        chip_indexes = packing.canonical_chip_order(
            _parse_chip_annotation(annotations[ann_key]))
        self._require_known_chips(chip_indexes)
        planned = [f"{device.hash}-{p}" for p in range(len(chip_indexes))]
        intent_id = self._journal_intent(owner, device, chip_indexes, planned)
        try:
            faults.fire("bind.post_journal")
            created: List[str] = []
            try:
                with get_tracer().span("materialize_nodes",
                                       chips=list(chip_indexes)):
                    for link_id, idx in zip(planned, chip_indexes):
                        self._operator.create(idx, link_id)
                        created.append(link_id)
                faults.fire("bind.post_create")
            except Exception:
                self._rollback_created(created)
                self._storage.journal_remove(intent_id)
                self._emit_rollback(owner, device, chip_indexes, intent_id,
                                    "materialize_failed")
                raise
            try:
                self._finish_bind(device, owner, pod, annotations,
                                  chip_indexes, created, intent_id=intent_id)
            except Exception:
                # _finish_bind rolled back the spec and links
                self._storage.journal_remove(intent_id)
                self._emit_rollback(owner, device, chip_indexes, intent_id,
                                    "handled_failure")
                raise
        finally:
            self._storage.intent_done(intent_id)

    def _rollback_created(self, created: List[str]) -> None:
        for link_id in created:
            try:
                self._operator.delete(link_id)
            except Exception:  # noqa: BLE001 - best effort, logged
                logger.warning("rollback: failed deleting %s", link_id)

    def _require_known_chips(self, chip_indexes: List[int]) -> None:
        unknown = [i for i in chip_indexes if i not in self._chips]
        if unknown:
            raise LocateError(f"cards {unknown} not present on this host")

    def _finish_bind(self, device: Device, owner, pod: dict,
                     annotations: Dict, chip_indexes: List[int],
                     created: List[str],
                     intent_id: Optional[int] = None) -> None:
        # One per-owner stripe spans the sibling lookup, the spec write and
        # the storage save that publishes this allocation: a core/memory
        # PreStart pair of one container racing here could otherwise both
        # miss the sibling and write unmerged specs.
        locks = _BIND_LOCKS  # one reference: acquire and release pair
        with get_tracer().span("bind_lock_wait") as sp:
            lock_wait_s = locks.acquire_key(owner.pod_key)
            sp.set(wait_ms=round(lock_wait_s * 1000, 3))
        try:
            if self._metrics is not None:
                self._metrics.bind_lock_wait.observe(lock_wait_s)
            own_path = os.path.join(self._alloc_dir, f"{device.hash}.json")
            fresh_bind = not os.path.exists(own_path)
            try:
                with get_tracer().span("write_alloc_spec", hash=device.hash):
                    self._write_alloc_spec(device, owner, chip_indexes,
                                           annotations, pod)
            except Exception:
                # Siblings are merged before the own file lands, so a
                # failure may have left them naming this allocation:
                # restore them. Only for a fresh bind: a failed re-bind
                # (container restart) leaves the still-valid specs alone.
                if fresh_bind:
                    try:
                        os.unlink(own_path)
                    except OSError:
                        pass
                    self._restore_sibling_specs(owner, device.hash)
                self._rollback_created(created)
                raise
            faults.fire("bind.post_spec")
            record = AllocationRecord(
                device=device, chip_indexes=chip_indexes,
                created_node_ids=created,
            )
            with get_tracer().span("checkpoint"):
                self._storage.mutate(
                    owner.namespace, owner.name,
                    lambda info: info.set_allocation(owner.container, record),
                )
            faults.fire("bind.post_checkpoint")
            if intent_id is not None:
                # commit inside the stripe: the reconciler re-checks an
                # open intent under this stripe too
                self._storage.journal_commit(intent_id)
        finally:
            locks.release_key(owner.pod_key)
        # The sink fan-out after the lock (the timeline journal, the gauge,
        # the CRD and Event enqueues) is its own phase of the bind: the
        # writes are asynchronous, the enqueue work runs on this thread.
        with get_tracer().span("sink_enqueue"):
            if self._timeline is not None:
                # journaled AFTER the checkpoint and the journal commit: a
                # crash in between is what the reconciler's intent repair
                # (and its reconcile_repair event) narrates instead
                self._timeline.emit(
                    tl.KIND_BIND_COMMIT,
                    keys=self._bind_keys(owner, device, chip_indexes),
                    resource=self.resource, intent_id=intent_id,
                    links=len(created),
                )
            if self._metrics is not None:
                self._metrics.bound_allocations.set(self._storage.count())
            if self._crd is not None:
                self._crd.record_bound(
                    device.hash, self.resource, len(device.ids),
                    owner.namespace, owner.name, owner.container,
                    chip_indexes, trace_id=get_tracer().current_id(),
                )
            if self._events is not None:
                self._events.pod_event(
                    owner.namespace, owner.name, ReasonBound,
                    f"bound {self.resource} ({len(device.ids)} units) to "
                    f"GPU card(s) {','.join(map(str, chip_indexes))}",
                    uid=pod.get("metadata", {}).get("uid", ""),
                )
        logger.info("bound %s %s -> %s cards %s", self.resource, device.hash,
                    owner.pod_key, chip_indexes)

    # -- the allocation spec for the injection -------------------------------

    def _spec_payload(self, device: Device, owner, chip_indexes: List[int],
                      annotations: Dict, pod: Optional[dict] = None) -> Dict:
        """The spec of one allocation: the bound cards' nodes, their
        control nodes (the operator's ``extra_paths``) and
        ``CUDA_VISIBLE_DEVICES`` by uuid, in the set's order, the quota
        env, and the bind's trace id, which the in-pod flight recorder
        (``workloads/telemetry.py``) tags its records with."""
        cards = [self._chips[i] for i in chip_indexes]
        env = visibility_env(cards)
        env.update(qos_env(annotations, pod_spec=pod,
                           **self._qos_kwargs(device)))
        trace_id = get_tracer().current_id()
        if trace_id:
            env["ELASTIC_TPU_TRACE_ID"] = trace_id
        return {
            "hash": device.hash,
            "resource": self.resource,
            "namespace": owner.namespace,
            "pod": owner.name,
            "container": owner.container,
            "chip_indexes": chip_indexes,
            "device_paths": [c.device_path for c in cards],
            "control_paths": list(dict.fromkeys(
                p for c in cards for p in c.extra_paths)),
            "env": env,
        }

    def _sibling_specs(self, owner) -> List[Dict]:
        """Spec payloads already written for the same container by the
        other resource's plugin."""
        info = self._storage.load(owner.namespace, owner.name)
        if info is None:
            return []
        out = []
        for resource, rec in info.allocations.get(owner.container, {}).items():
            if resource == self.resource:
                continue
            path = os.path.join(self._alloc_dir, f"{rec.device.hash}.json")
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        return out

    def _write_alloc_spec(self, device: Device, owner,
                          chip_indexes: List[int], annotations: Dict,
                          pod: Optional[dict] = None) -> None:
        """Write the spec, merged with the sibling resource's spec of the
        same container (the caller holds the owner's stripe).

        Both Allocate answers of a container carry ``TPU=<own hash>`` and
        the kubelet merges env in no set order, so the injection resolves
        whichever hash won. Every spec file of the container carries the
        union of both resources' devices and env, so the injection is the
        same either way (the reference injected the winner's alone,
        gpushare.go:79-82/204-207)."""
        os.makedirs(self._alloc_dir, exist_ok=True)
        payload = self._spec_payload(device, owner, chip_indexes,
                                     annotations, pod)
        # pre-merge snapshot: a later release of the sibling restores this
        # spec to exactly its own content
        payload["own"] = {
            "chip_indexes": list(payload["chip_indexes"]),
            "device_paths": list(payload["device_paths"]),
            "control_paths": list(payload["control_paths"]),
            "env": dict(payload["env"]),
        }
        for sib in self._sibling_specs(owner):
            payload, merged_sib = _merge_spec_payloads(payload, sib)
            _write_json_atomic(
                os.path.join(self._alloc_dir, f"{merged_sib['hash']}.json"),
                merged_sib,
            )
        _write_json_atomic(
            os.path.join(self._alloc_dir, f"{device.hash}.json"), payload
        )

    def _restore_sibling_specs(self, owner, released_hash: str) -> None:
        """(owner's stripe held) Rewrite the container's surviving sibling
        specs from their ``own`` snapshots, so that the released
        allocation's devices and env leave them."""
        info = self._storage.load(owner.namespace, owner.name)
        siblings = info.allocations.get(owner.container, {}) if info else {}
        for rec in siblings.values():
            if rec.device.hash == released_hash:
                continue
            path = os.path.join(self._alloc_dir, f"{rec.device.hash}.json")
            try:
                with open(path) as f:
                    spec = json.load(f)
            except (OSError, ValueError):
                continue
            own = spec.get("own")
            if not own:
                continue
            restored = dict(spec)
            restored.update(own)
            restored["resources"] = [restored.get("resource", "")]
            _write_json_atomic(path, restored)

    def _remove_sidecars(self, alloc_hash: str) -> None:
        """Remove the allocation's sidecar files (usage report, checkpoint
        ack, flight summary) with its spec: a stale ack under a reused
        hash would read as a fresh one."""
        for subdir in AllocSidecarSubdirs:
            for suffix in (".json", ".json.tmp"):
                try:
                    os.unlink(os.path.join(self._alloc_dir, subdir,
                                           f"{alloc_hash}{suffix}"))
                except OSError:
                    pass

    def remove_alloc_spec(self, alloc_hash: str, owner) -> None:
        """Unlink an allocation's spec and sidecars, and restore the
        container's surviving sibling specs."""
        with bind_lock(owner.pod_key):
            self.remove_alloc_spec_locked(alloc_hash, owner)

    def remove_alloc_spec_locked(self, alloc_hash: str, owner) -> None:
        """remove_alloc_spec for a caller already holding the owner's bind
        stripe (the reconciler's intent rollback and drift repair)."""
        try:
            os.unlink(os.path.join(self._alloc_dir, f"{alloc_hash}.json"))
        except FileNotFoundError:
            pass
        self._remove_sidecars(alloc_hash)
        self._restore_sibling_specs(owner, alloc_hash)

    def alloc_spec_exists(self, alloc_hash: str) -> bool:
        """Whether an allocation's spec file is on disk."""
        return os.path.exists(
            os.path.join(self._alloc_dir, f"{alloc_hash}.json"))

    def read_alloc_spec(self, alloc_hash: str) -> Optional[Dict]:
        """The on-disk spec of an allocation; None when absent or
        corrupt."""
        try:
            with open(os.path.join(self._alloc_dir,
                                   f"{alloc_hash}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def restamp_spec_env_locked(self, owner, records: Dict,
                                env_updates: Dict[str, str],
                                remove_keys=()) -> int:
        """(owner's stripe held) Set ``env_updates`` and drop
        ``remove_keys`` in every on-disk spec of this container, in the
        merged env and the pre-merge ``own`` snapshot both, atomically per
        file, without re-running the bind: the cards stay as bound. The
        drain's signal (and its removal on cancel), the cutover and the
        restore stamp go through here. Returns the specs that carry the
        env afterwards (an already-stamped spec counts and is not
        rewritten, so that re-stamping every tick is cheap)."""
        restamped = 0
        for record in records.values():
            path = os.path.join(self._alloc_dir, f"{record.device.hash}.json")
            try:
                with open(path) as f:
                    spec = json.load(f)
            except (OSError, ValueError):
                continue
            targets = [spec.setdefault("env", {})]
            own = spec.get("own")
            if isinstance(own, dict):
                targets.append(own.setdefault("env", {}))
            changed = False
            for env in targets:
                for key, value in env_updates.items():
                    if env.get(key) != value:
                        env[key] = value
                        changed = True
                for key in remove_keys:
                    if env.pop(key, None) is not None:
                        changed = True
            if changed:
                _write_json_atomic(path, spec)
            # crash window between the sibling specs of one container
            faults.fire("restamp.spec_file")
            restamped += 1
        return restamped

    def locator_stats(self) -> Dict:
        """The locator's cache stats (empty when it keeps none)."""
        stats = getattr(self._locator, "stats", None)
        return stats() if stats is not None else {}

    def bind_stats(self) -> Dict:
        """This resource's binds: in flight, done and failed."""
        with self._bind_count_lock:
            return dict(self._bind_counts)

    def rebind(self, owner, device: Device) -> None:
        """The reconciler's entry point: the whole bind transaction for an
        owner already located (its own intent, the links, the merged spec,
        the record). It replays a bind that the kubelet's assignment
        proves happened but a crash cut short, rebuilds a missing spec,
        and rebinds after a kubelet restart handed the container other
        ids."""
        pod = self._lookup_pod(owner)
        if pod is None:
            raise LocateError(f"pod {owner.pod_key} not found anywhere")
        get_tracer().annotate(
            pod=f"{owner.namespace}/{owner.name}", container=owner.container)
        if self._timeline is not None:
            # the transaction below journals its own intent and commit;
            # this marks them as a recovery replay, not a kubelet bind
            self._timeline.emit(
                tl.KIND_BIND_REPLAY,
                keys=self._bind_keys(owner, device, []),
                resource=self.resource,
            )
        self._bind_located(device, owner, pod)


class GPUShareCorePlugin(_GPUSharePluginBase):
    """elasticgpu.io/gpu-core: 100 fake units a card."""

    resource = ResourceGPUCore

    def device_list(self) -> List[Tuple[str, str]]:
        # whole-card mode: one id a card (the reference's no-op operator's
        # shape); 100 units would let the kubelet split one card's units
        # across two pods, each handed the whole card
        units = 1 if self._whole_chip else GPUPercentEachCard
        out = []
        for chip in self._chips.values():
            health = self._chip_health(chip.index)
            out.extend((core_device_id(chip.index, u), health)
                       for u in range(units))
        return out

    def _alloc_envs(self, device: Device) -> Dict[str, str]:
        envs = super()._alloc_envs(device)
        if self._whole_chip:
            # the cards the ids name, as the device specs; in shared mode
            # the card is known at PreStart only, and the spec carries it
            envs.update(visibility_env(
                self._chips[c] for c in self._known_chips_from_ids(device)))
        return envs

    def _alloc_device_specs(self, device: Device) -> List[DeviceSpec]:
        nodes = [self._chips[c].device_path
                 for c in self._known_chips_from_ids(device)] \
            if self._whole_chip else []
        # each node at its host name; the control nodes in both modes
        return [DeviceSpec(container_path=p, host_path=p)
                for p in nodes + self._control_paths]

    def _qos_kwargs(self, device: Device) -> Dict:
        if self._whole_chip:
            # one id is one whole card: 100 units of it, not 1
            n = len(self._known_chips_from_ids(device)) or len(device.ids)
            return {"core_units": GPUPercentEachCard * n}
        return {"core_units": len(device.ids)}


class GPUShareMemoryPlugin(_GPUSharePluginBase):
    """elasticgpu.io/gpu-memory: one fake unit a MiB of the card's memory
    (81,559 units an H100 SXM5 card)."""

    resource = ResourceGPUMemory

    def __init__(self, config: PluginConfig) -> None:
        super().__init__(config)
        chips = list(self._chips.values())
        self._mib_per_chip = (
            chips[0].hbm_bytes // BytesPerMemoryUnit if chips else 0
        )

    def device_list(self) -> List[Tuple[str, str]]:
        out = []
        for chip in self._chips.values():
            health = self._chip_health(chip.index)
            out.extend((mem_device_id(chip.index, u), health)
                       for u in range(chip.hbm_bytes // BytesPerMemoryUnit))
        return out

    def _hbm_limit_bytes(self, device: Device) -> int:
        return len(device.ids) * BytesPerMemoryUnit

    def _qos_kwargs(self, device: Device) -> Dict:
        return {
            "hbm_limit_bytes": self._hbm_limit_bytes(device),
            "chip_hbm_bytes": self._mib_per_chip * BytesPerMemoryUnit,
        }

    def _spec_payload(self, device, owner, chip_indexes, annotations,
                      pod=None):
        payload = super()._spec_payload(device, owner, chip_indexes,
                                        annotations, pod)
        payload["hbm_limit_bytes"] = self._hbm_limit_bytes(device)
        return payload


class GPUSharePlugin:
    """The two per-resource servers, their health loop and the GC loop
    (reference GPUSharePlugin, base.go:203-306), which the manager runs as
    supervised subsystems."""

    def __init__(self, config: PluginConfig) -> None:
        self._config = config
        self.core = GPUShareCorePlugin(config)
        self.memory = GPUShareMemoryPlugin(config)
        self.servers = [
            DevicePluginServer(self.core, ResourceGPUCore, CORE_ENDPOINT,
                               config),
            DevicePluginServer(self.memory, ResourceGPUMemory, MEM_ENDPOINT,
                               config),
        ]

    def plugin_for_resource(self, resource: str):
        """The per-resource plugin of ``resource``; None when it is not
        ours (the reconciler skips other extended resources in the
        kubelet's pod-resources dump)."""
        return {
            ResourceGPUCore: self.core,
            ResourceGPUMemory: self.memory,
        }.get(resource)

    @property
    def cordoned(self) -> bool:
        return self.core.cordoned

    def set_cordoned(self, flag: bool) -> None:
        """The drain's cordon on both resources (they never disagree on
        schedulability, as on health), journaled on a change."""
        changed = bool(flag) != self.core.cordoned
        self.core.set_cordoned(flag)
        self.memory.set_cordoned(flag)
        if changed and self._config.timeline is not None:
            self._config.timeline.emit(
                tl.KIND_CORDON, keys={"chips": sorted(self.core._chips)},
                cordoned=bool(flag),
            )

    def locator_stats(self) -> Dict[str, Dict]:
        """Each resource's locator cache stats."""
        return {ResourceGPUCore: self.core.locator_stats(),
                ResourceGPUMemory: self.memory.locator_stats()}

    def bind_stats(self) -> Dict:
        """The bind pipeline: the gRPC pool size of each resource server
        and each resource's binds in flight, done and failed."""
        return {
            "grpc_pool_size": self._config.grpc_pool_size,
            "resources": {ResourceGPUCore: self.core.bind_stats(),
                          ResourceGPUMemory: self.memory.bind_stats()},
        }

    def run(self, stop: threading.Event) -> None:
        for server in self.servers:
            server.start(stop)

    # -- card health ----------------------------------------------------------

    # Policy hooks the manager sets (the agent's, plugins/tpushare.py):
    # on_chips_failed(went_bad, reasons) and on_chips_recovered(recovered)
    # on health flips; NRI eviction of the containers injected with a dead
    # card, and its clearing when the card comes back.
    on_chips_failed = None
    on_chips_recovered = None

    def health_once(self) -> bool:
        """One health poll: probe the operator once, fold in the
        utilization sampler's flags (a card whose telemetry keeps failing
        degrades like one the operator reports broken), apply the same
        view to both resources, then call the policy hooks on flips.
        Returns True when anything changed."""
        faults.fire("health.poll")
        try:
            healthy = set(self._config.operator.healthy_indexes())
        except Exception:  # noqa: BLE001 - a broken probe must not wedge
            logger.exception("health probe failed")
            return False
        sampler = self._config.sampler
        sampler_reasons: Dict[int, str] = {}
        if sampler is not None:
            try:
                flagged = sampler.unhealthy_chips()
                if flagged:
                    sampler_reasons = sampler.health_reasons()
                    healthy -= flagged
            except Exception:  # noqa: BLE001 - never load-bearing
                logger.exception("sampler health view failed")
        went_bad, recovered = self.core.apply_health(healthy)
        self.memory.apply_health(healthy)
        reasons = {}
        if went_bad or recovered:
            try:
                reasons = dict(self._config.operator.health_reasons())
            except Exception:  # noqa: BLE001 - reasons are best-effort
                pass
            # the operator's reasons win (more specific); the sampler's
            # fill in for the cards only it flagged
            for idx, why in sampler_reasons.items():
                reasons.setdefault(idx, why)
            self._report_health(went_bad, recovered, reasons)
        if self._config.metrics is not None:
            self._config.metrics.healthy_chips.set(
                len(self.core._chips) - len(self.core.unhealthy_chips()))
        if self.on_chips_failed is not None and went_bad:
            try:
                self.on_chips_failed(set(went_bad), reasons)
            except Exception:  # noqa: BLE001 - policy must not wedge health
                logger.exception("card-failure policy hook failed")
        if self.on_chips_recovered is not None and recovered:
            try:
                self.on_chips_recovered(set(recovered))
            except Exception:  # noqa: BLE001
                logger.exception("card-recovery policy hook failed")
        return bool(went_bad or recovered)

    def _report_health(self, went_bad: set, recovered: set,
                       reasons: Dict[int, str]) -> None:
        """Health flips to the CRD inventory, the node's and the bound
        pods' Events and the timeline."""
        config = self._config
        if config.crd_recorder is not None:
            for idx in sorted(went_bad):
                config.crd_recorder.record_chip_health(
                    idx, False, reasons.get(idx, "reported unhealthy"))
            for idx in sorted(recovered):
                config.crd_recorder.record_chip_health(idx, True)
        events = config.events
        if events is not None:
            for idx in sorted(went_bad):
                why = reasons.get(idx, "reported unhealthy by operator")
                events.node_event(
                    ReasonChipUnhealthy,
                    f"GPU card {idx} unhealthy ({why}); "
                    "kubelet will stop placing units on it",
                    type_="Warning",
                )
            for idx in sorted(recovered):
                events.node_event(ReasonChipHealthy,
                                  f"GPU card {idx} recovered")
            if went_bad:
                self._warn_bound_pods(events, went_bad)
        if config.timeline is not None:
            if went_bad:
                config.timeline.emit(
                    tl.KIND_CHIP_HEALTH, keys={"chips": sorted(went_bad)},
                    healthy=False,
                    reasons={str(i): reasons[i] for i in sorted(went_bad)
                             if i in reasons},
                )
            if recovered:
                config.timeline.emit(
                    tl.KIND_CHIP_HEALTH, keys={"chips": sorted(recovered)},
                    healthy=True,
                )

    def _warn_bound_pods(self, events, went_bad: set) -> None:
        """Tell each pod bound to a newly dead card that its device is
        gone: ``kubectl describe pod`` answers "why did my job stall"."""
        for _, info in list(self._config.storage.items()):
            for record in info.records():
                hit = sorted(set(record.chip_indexes) & went_bad)
                if hit:
                    events.pod_event(
                        info.namespace, info.name, ReasonChipUnhealthy,
                        f"GPU card(s) {','.join(map(str, hit))} bound to "
                        "this pod became unhealthy",
                        type_="Warning",
                    )

    def health_loop(self, stop: threading.Event) -> None:
        """Poll at once, then every HEALTH_PERIOD_S: a card that died
        between discovery and the plugins' start must not be advertised
        Healthy for a whole period."""
        while True:
            try:
                self.health_once()
            except Exception:  # noqa: BLE001
                logger.exception("health poll failed")
            if stop.wait(HEALTH_PERIOD_S):
                return

    # -- GC (reference: base.go:241-306) --------------------------------------

    def _pod_is_gone(self, namespace: str, name: str) -> bool:
        sitter = self._config.sitter
        if sitter.get_pod(namespace, name) is not None:
            return False
        try:
            return sitter.get_pod_from_api(namespace, name) is None
        except Exception as e:  # noqa: BLE001 - apiserver down: keep state
            logger.warning("GC: apiserver check failed for %s/%s: %s",
                           namespace, name, e)
            return False

    def gc_once(self, trigger: str = "poll") -> int:
        """Reclaim the allocations of pods that no longer exist: their
        links, specs, sidecars and records. Returns the pods reclaimed.
        ``trigger`` says what woke the sweep (``event``: a deletion the
        sitter queued; ``poll``: the periodic tick), for the detection-lag
        tracker."""
        faults.fire("gc.sweep")
        with get_tracer().trace("gc_sweep") as tr:
            reclaimed = self._gc_sweep(trigger)
            tr.set(reclaimed=reclaimed)
            if reclaimed == 0:
                # the periodic tick fires forever; empty sweeps would churn
                # real allocation traces out of the bounded ring
                tr.discard()
        return reclaimed

    def _gc_sweep(self, trigger: str) -> int:
        reclaimed = 0
        config = self._config
        storage = config.storage
        operator = config.operator
        for key, info in list(storage.items()):
            if not self._pod_is_gone(info.namespace, info.name):
                continue
            with get_tracer().span("reclaim_pod", pod=key) as sp:
                get_tracer().annotate_pod(key)
                hashes = []
                for container, by_resource in info.allocations.items():
                    owner = PodContainer(info.namespace, info.name, container)
                    for record in by_resource.values():
                        hashes.append(record.device.hash)
                        for link_id in record.created_node_ids:
                            try:
                                operator.delete(link_id)
                            except Exception:  # noqa: BLE001 - swept on
                                logger.warning(
                                    "GC: failed deleting node %s", link_id)
                        # the owner is passed, so a sibling outliving this
                        # unlink never names the freed devices
                        self.core.remove_alloc_spec(record.device.hash, owner)
                        if config.crd_recorder is not None:
                            config.crd_recorder.record_released(
                                record.device.hash)
                sp.set(hashes=hashes)
                storage.delete(info.namespace, info.name)
                if config.timeline is not None:
                    config.timeline.emit(
                        tl.KIND_POD_RECLAIMED,
                        keys={"pod": key, "hash": hashes[0] if hashes else ""},
                        source="gc", hashes=hashes,
                    )
            reclaimed += 1
            if config.lag_tracker is not None:
                config.lag_tracker.handled("gc", "reclaimed_pod", key=key,
                                           trigger=trigger)
            if config.events is not None:
                # the pod no longer exists: the Event lands on this Node
                config.events.node_event(
                    ReasonReclaimed,
                    f"reclaimed GPU allocation(s) of deleted pod {key}",
                )
            logger.info("GC: reclaimed %s", key)
        if config.metrics is not None:
            if reclaimed:
                config.metrics.gc_reclaimed.inc(reclaimed)
            config.metrics.bound_allocations.set(storage.count())
        return reclaimed

    def gc(self, gc_queue: "queue.Queue", stop: threading.Event) -> None:
        """Sweep on each pod deletion the sitter queues, else every
        GC_PERIOD_S, until ``stop``."""
        while not stop.is_set():
            trigger = "event"
            try:
                gc_queue.get(timeout=GC_PERIOD_S)
            except queue.Empty:
                trigger = "poll"
            if stop.is_set():
                return
            try:
                self.gc_once(trigger)
            except Exception:  # noqa: BLE001
                logger.exception("GC pass failed")

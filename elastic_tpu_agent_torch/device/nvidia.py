"""NVIDIA host operator: card discovery, health and telemetry.

Counterpart of ``elastic_tpu_agent/tpu/tpuvm.py``. Its sources, each
injectable for tests and each tolerated when absent:

1. the ``/dev/nvidia<minor>`` nodes (and ``nvidiactl``, ``nvidia-uvm``,
   ``nvidia-uvm-tools``) under the scanned dev root;
2. one ``nvidia-smi -q -x`` call, parsed by tag name with ``xml.etree``:
   each card's uuid, minor number, product name, framebuffer total and
   used, utilization, ECC counters and row-remapping state. Its
   field names change across drivers, so every field may be missing or
   ``N/A``. One call, cached for ``smi_ttl_s``, serves discovery, health
   and telemetry: a call costs tens of milliseconds and the agent's
   sampler polls;
3. the card table (``topology.py``) for the SMs of each product;
4. env (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``: the agent's slice
   contract) for the host's place in a multi-host slice;
5. the GCE metadata server's ``maintenance-event`` and ``preempted``,
   which H100 VMs on GCE serve as TPU VMs do; elsewhere they read None
   and False.

A card's index is its node minor, as the TPU operator's is the N of
``/dev/accelN``: the driver keeps a card's minor while it stays loaded, so
an index stored by the agent (a bind's ``chip_indexes``) names the same
card after the agent restarts, whichever cards nvidia-smi lists then.
nvidia-smi's own index (PCI order) is not used: a card missing from one
listing would shift every later card's. Cards are pinned in a container by
uuid (``qos.visibility_env``).

A failed nvidia-smi call changes nothing: the last good listing stays, so
health and the inventory hold, and telemetry reads ``{"error": ...}``
until a call succeeds. A card is "not listed" only when a listing that
parsed leaves out a card an earlier one showed: a container's /dev may
hold nodes of cards it cannot use, so a node alone is never judged. At
the first read, with nvidia nodes present, a
failed call is retried before the inventory is taken as empty.

This module imports neither torch nor any CUDA library: the agent's
process must hold no CUDA context, which would take memory on every card
and show in every tenant's ``hbm_used_bytes``.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import subprocess
import time
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .operator import (
    CONTROL_NODES,
    GPUChip,
    LinkingOperator,
    is_char_device,
)
from .topology import (
    FALLBACK_SPEC, MiB, TopologyInfo, host_topology, spec_for_product,
)

logger = logging.getLogger(__name__)

_METADATA_ROOT = "http://metadata.google.internal/computeMetadata/v1/instance/"
_MAINTENANCE_EVENT_URL = _METADATA_ROOT + "maintenance-event"
_PREEMPTED_URL = _METADATA_ROOT + "preempted"
_METADATA_TIMEOUT_S = 2.0
# the metadata polls: at most once a TTL, and after a transport failure
# (no metadata server) not again for the backoff (tpuvm.py's defaults and
# env overrides)
_MAINTENANCE_POLL_TTL_S = 30.0
_MAINTENANCE_ERROR_BACKOFF_S = 300.0

# one nvidia-smi call serves every read within this many seconds
SMI_TTL_S = 2.0
_SMI_TIMEOUT_S = 30.0
# the first read, with nvidia nodes present: this many retries of a failed
# nvidia-smi call, this far apart, before the inventory reads empty
SMI_BOOT_RETRIES = 3
SMI_BOOT_RETRY_DELAY_S = 1.0
# only counters that mean "this card is broken" flip health: correctable
# errors tick during normal operation (tpuvm.py's rule)
_FATAL_COUNTER_SUBSTRINGS = ("uncorrectable",)
_UNITS = {"B": 1, "KiB": 1024, "MiB": MiB, "GiB": 1024 * MiB}

SmiSource = Callable[[], Optional[str]]


def _fetch_metadata_url(url: str) -> Optional[str]:
    req = urllib.request.Request(url, headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=_METADATA_TIMEOUT_S) as r:
            if r.status == 200:
                return r.read().decode().strip()
    except Exception:  # noqa: BLE001 - any transport failure = "absent"
        pass
    return None


def _default_maintenance_fetcher() -> Optional[str]:
    return _fetch_metadata_url(_MAINTENANCE_EVENT_URL)


def _default_preempted_fetcher() -> Optional[str]:
    return _fetch_metadata_url(_PREEMPTED_URL)


def run_nvidia_smi() -> Optional[str]:
    """``nvidia-smi -q -x``'s output; None when it is absent or fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-q", "-x"], capture_output=True, text=True,
            timeout=_SMI_TIMEOUT_S,
        )
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("nvidia-smi unavailable: %s", e)
        return None
    if proc.returncode != 0:
        logger.warning("nvidia-smi exited %d: %s", proc.returncode,
                       proc.stderr.strip()[:200])
        return None
    return proc.stdout


def _int(text: Optional[str]) -> Optional[int]:
    try:
        return int((text or "").strip())
    except ValueError:
        return None


def parse_bytes(text: Optional[str]) -> Optional[int]:
    """"81559 MiB" -> bytes; None for N/A or anything else."""
    parts = (text or "").split()
    if len(parts) != 2 or parts[1] not in _UNITS:
        return None
    value = _int(parts[0])
    return None if value is None else value * _UNITS[parts[1]]


def parse_percent(text: Optional[str]) -> Optional[float]:
    """"37 %" -> 37.0; None for N/A or anything else."""
    raw = (text or "").strip()
    if raw.endswith("%"):
        raw = raw[:-1].strip()
    try:
        return float(raw)
    except ValueError:
        return None


def _leaves(elem, prefix: str) -> Dict[str, int]:
    """{"<prefix>/<tag>/...": int} for every integer leaf under elem."""
    out: Dict[str, int] = {}
    for child in elem:
        path = f"{prefix}/{child.tag}"
        if len(child):
            out.update(_leaves(child, path))
        else:
            value = _int(child.text)
            if value is not None:
                out[path] = value
    return out


@dataclass
class SmiGPU:
    """One ``<gpu>`` of nvidia-smi's XML, every field optional."""

    uuid: str
    minor: Optional[int]
    product: str
    fb_total_bytes: Optional[int]
    fb_used_bytes: Optional[int]
    gpu_util: Optional[str]          # raw text; None when absent
    counters: Dict[str, int] = field(default_factory=dict)  # ecc_errors/...
    remap_failed: bool = False


def parse_smi_xml(text: str) -> Tuple[str, List[SmiGPU]]:
    """(driver version, the cards in listing order) from ``nvidia-smi -q
    -x``; raises ``ET.ParseError`` on text that is not XML."""
    root = ET.fromstring(text)
    gpus = []
    for g in root.iter("gpu"):
        ecc = g.find("ecc_errors")
        remap = g.find("remapped_rows")
        gpus.append(SmiGPU(
            uuid=(g.findtext("uuid") or "").strip(),
            minor=_int(g.findtext("minor_number")),
            product=(g.findtext("product_name") or "").strip(),
            fb_total_bytes=parse_bytes(g.findtext("fb_memory_usage/total")),
            fb_used_bytes=parse_bytes(g.findtext("fb_memory_usage/used")),
            gpu_util=g.findtext("utilization/gpu_util"),
            counters={} if ecc is None else _leaves(ecc, "ecc_errors"),
            remap_failed=remap is not None and any(
                "failure" in c.tag and (c.text or "").strip() == "Yes"
                for c in remap.iter()),
        ))
    return (root.findtext("driver_version") or "").strip(), gpus


class NvidiaOperator(LinkingOperator):
    """Discovery against a real (or, in tests, a faked) NVIDIA host."""

    def __init__(
        self,
        dev_root: str,
        host_dev_scan_root: Optional[str] = None,
        smi: SmiSource = run_nvidia_smi,
        env: Optional[Dict[str, str]] = None,
        maintenance: Callable[[], Optional[str]] = (
            _default_maintenance_fetcher),
        preemption: Callable[[], Optional[str]] = _default_preempted_fetcher,
        maintenance_poll_ttl_s: Optional[float] = None,
        maintenance_error_backoff_s: Optional[float] = None,
        smi_ttl_s: float = SMI_TTL_S,
        sleep: Callable[[float], None] = time.sleep,
        stat_fn: Callable = os.stat,
    ) -> None:
        # dev_root: where virtual links are made (the host /dev mount);
        # host_dev_scan_root: where the nvidia nodes are looked for
        super().__init__(dev_root)
        self._scan_root = host_dev_scan_root or dev_root
        self._stat = stat_fn
        self._smi = smi
        self._smi_ttl_s = smi_ttl_s
        self._sleep = sleep
        self._env = env if env is not None else dict(os.environ)
        # the last listing that parsed, as (index = minor, card)
        self._listing: List[Tuple[int, SmiGPU]] = []
        self._listed_at: Optional[float] = None
        self._read_ok: Optional[bool] = None     # None: never read
        self.driver_version = ""
        # every index a parsed listing has shown
        self._seen: set = set()
        self._topology: Optional[TopologyInfo] = None
        # health: card -> {counter path: baseline}; a card whose counter
        # rose past its baseline stays unhealthy until the agent restarts
        self._counter_base: Dict[int, Dict[str, int]] = {}
        self._error_chips: set = set()
        self._sticky_reasons: Dict[int, str] = {}
        self._health_reasons: Dict[int, str] = {}
        self._maintenance = maintenance
        self._maint_cached: Optional[str] = None
        self._maint_next_poll = 0.0
        self._preemption = preemption
        self._preempt_cached: Optional[str] = None
        self._preempt_next_poll = 0.0

        def _ttl(key: str, arg: Optional[float], default: float) -> float:
            if arg is not None:
                return arg
            raw = self._env.get(key)
            try:
                return float(raw) if raw else default
            except ValueError:
                return default

        self._maint_poll_ttl_s = _ttl(
            "ELASTIC_TPU_MAINTENANCE_POLL_TTL", maintenance_poll_ttl_s,
            _MAINTENANCE_POLL_TTL_S)
        self._maint_error_backoff_s = _ttl(
            "ELASTIC_TPU_MAINTENANCE_ERROR_BACKOFF",
            maintenance_error_backoff_s, _MAINTENANCE_ERROR_BACKOFF_S)

    # -- inventory sources ---------------------------------------------------

    def _read(self) -> Optional[List[SmiGPU]]:
        """One nvidia-smi call's cards; None when it fails or does not
        parse."""
        text = self._smi()
        if not text:
            return None
        try:
            self.driver_version, gpus = parse_smi_xml(text)
        except ET.ParseError as e:
            logger.warning("nvidia-smi XML does not parse: %s", e)
            return None
        return gpus

    def _snapshot(self) -> List[Tuple[int, SmiGPU]]:
        """(index, card) for every card of the last listing that parsed
        (TTL-cached); empty until one has."""
        now = time.monotonic()
        if (self._listed_at is not None
                and now - self._listed_at < self._smi_ttl_s):
            return self._listing
        gpus = self._read()
        if gpus is None and self._read_ok is None and self._present_minors():
            for _ in range(SMI_BOOT_RETRIES):
                self._sleep(SMI_BOOT_RETRY_DELAY_S)
                gpus = self._read()
                if gpus is not None:
                    break
        self._listed_at = now
        if gpus is None:
            if self._read_ok is not False:
                logger.warning("nvidia-smi gave no listing; keeping the "
                               "last one (%d cards)", len(self._listing))
            self._read_ok = False
            return self._listing
        self._read_ok = True
        listing = []
        for ordinal, g in enumerate(gpus):
            if not g.uuid or g.minor is None:
                logger.warning("nvidia-smi card %d has no uuid or minor "
                               "number; skipped", ordinal)
                continue
            listing.append((g.minor, g))
        self._seen.update(i for i, _ in listing)
        self._listing = listing
        return listing

    def _present_minors(self) -> set:
        found = set()
        for path in glob.glob(os.path.join(self._scan_root, "nvidia[0-9]*")):
            m = re.search(r"nvidia(\d+)$", path)
            if m:
                found.add(int(m.group(1)))
        return found

    def _extra_paths(self) -> List[str]:
        """The control nodes the host holds as character devices."""
        out = []
        for n in CONTROL_NODES:
            try:
                st = self._stat(os.path.join(self._scan_root, n))
            except OSError:
                continue
            if is_char_device(st):
                out.append(os.path.join(self._target_root, n))
        return out

    def worker_id(self) -> int:
        try:
            return int(self._env.get("TPU_WORKER_ID") or 0)
        except ValueError:
            return 0

    def worker_hostnames(self) -> List[str]:
        raw = self._env.get("TPU_WORKER_HOSTNAMES") or ""
        return [h for h in raw.split(",") if h]

    @property
    def topology(self) -> Optional[TopologyInfo]:
        """This host's cards and the slice's hosts; None until a card is
        listed."""
        if self._topology is None:
            listing = self._snapshot()
            if listing:
                product = listing[0][1].product
                if spec_for_product(product) is None:
                    logger.warning(
                        "unknown card %r: advertising %d SM and %d MiB "
                        "unless nvidia-smi reports its memory", product,
                        FALLBACK_SPEC.cores_per_chip,
                        FALLBACK_SPEC.hbm_bytes // MiB)
                self._topology = host_topology(
                    product, len(listing), len(self.worker_hostnames()))
        return self._topology

    # -- GPUOperator ---------------------------------------------------------

    def devices(self) -> List[GPUChip]:
        extra = self._extra_paths()
        out = []
        for index, g in self._snapshot():
            spec = spec_for_product(g.product) or FALLBACK_SPEC
            out.append(GPUChip(
                uuid=g.uuid, index=index, device_path=self.node_path(g.minor),
                hbm_bytes=g.fb_total_bytes or spec.hbm_bytes,
                cores=spec.cores_per_chip, extra_paths=list(extra),
            ))
        return out

    # -- health ---------------------------------------------------------------

    def maintenance_event(self) -> Optional[str]:
        """GCE's maintenance-event, TTL-cached: "NONE" while quiet, the
        event's name while one is announced, None while unreachable."""
        now = time.monotonic()
        if now >= self._maint_next_poll:
            val = self._maintenance()
            self._maint_cached = val
            self._maint_next_poll = now + (
                self._maint_poll_ttl_s if val is not None
                else self._maint_error_backoff_s)
        return self._maint_cached

    def preempted(self) -> bool:
        """True once GCE announces this spot instance's preemption."""
        now = time.monotonic()
        if now >= self._preempt_next_poll:
            val = self._preemption()
            self._preempt_cached = val
            self._preempt_next_poll = now + (
                self._maint_poll_ttl_s if val is not None
                else self._maint_error_backoff_s)
        return (self._preempt_cached or "").strip().upper() == "TRUE"

    def _scan_error_counters(self, listing) -> None:
        """Fold each card's volatile uncorrectable ECC counters into the
        sticky error set: a counter's first reading is its baseline, a
        later rise marks the card, a fall (a reset) re-baselines."""
        for index, g in listing:
            base = self._counter_base.setdefault(index, {})
            for path, value in g.counters.items():
                name = path.rsplit("/", 1)[-1]
                if "/volatile/" not in path or not any(
                        s in name for s in _FATAL_COUNTER_SUBSTRINGS):
                    continue
                if path not in base:
                    base[path] = value
                elif value > base[path]:
                    if index not in self._error_chips:
                        logger.warning("card %d: %s %d -> %d; marking "
                                       "unhealthy", index, path,
                                       base[path], value)
                    self._error_chips.add(index)
                    self._sticky_reasons[index] = (
                        f"uncorrectable ECC counter {path} rose to {value}")
                elif value < base[path]:
                    base[path] = value

    def healthy_indexes(self) -> set:
        """A card is healthy while nvidia-smi lists it, its node is
        present, no volatile uncorrectable ECC counter has risen past its
        baseline and its row remapping has not failed. A failed
        nvidia-smi call keeps the last listing's verdicts."""
        listing = self._snapshot()
        listed = {i for i, _ in listing}
        present = self._present_minors()
        reasons = {i: "not listed by nvidia-smi"
                   for i in self._seen - listed}
        for index, g in listing:
            if g.minor not in present:
                reasons[index] = f"device node nvidia{g.minor} missing"
            elif g.remap_failed:
                reasons[index] = "row remapping failed"
        self._scan_error_counters(listing)
        for index in self._error_chips:
            reasons[index] = self._sticky_reasons[index]
        self._health_reasons = reasons
        return listed - set(reasons)

    def health_reasons(self) -> Dict[int, str]:
        return dict(self._health_reasons)

    # -- telemetry (the agent's sampler) ---------------------------------------

    def utilization(self) -> Dict[int, dict]:
        """{index: {"duty_cycle_percent", "hbm_used_bytes"}} from
        nvidia-smi's ``gpu_util`` (the share of the last sample period in
        which a kernel ran) and framebuffer used. A card without a
        ``gpu_util`` gives no entry; one whose value does not parse, and
        every card while nvidia-smi fails, gives {"error": ...}."""
        out: Dict[int, dict] = {}
        listing = self._snapshot()
        if self._read_ok is False:
            return {index: {"error": "nvidia-smi gave no listing"}
                    for index, _ in listing}
        for index, g in listing:
            if g.gpu_util is None:
                continue
            duty = parse_percent(g.gpu_util)
            if duty is None:
                out[index] = {"error": f"unparseable gpu_util "
                                       f"{g.gpu_util.strip()!r}"}
                continue
            out[index] = {"duty_cycle_percent": duty,
                          "hbm_used_bytes": g.fb_used_bytes or 0}
        return out

    def error_counters(self) -> Dict[int, Dict[str, int]]:
        """Every ECC counter nvidia-smi reports, by card."""
        return {index: dict(g.counters)
                for index, g in self._snapshot() if g.counters}

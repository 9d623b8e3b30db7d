"""GPU operator contract and the virtual-device-node mechanics.

Counterpart of ``elastic_tpu_agent/tpu/operator.py``. The agent reads its
operator by duck typing (``manager.py`` ``ManagerOptions.operator``, the
plugins' ``devices()``/``create``/``delete``/``check``, ``topology``,
``virtual_nodes``, the drain loop's ``maintenance_event``/``preempted``),
so an operator from this module drops into the agent's unchanged plugins.
The port keeps its own copy of the contract: it imports nothing of the
agent.

The virtual-device scheme is the agent's: a hash-named symlink
``/dev/elastic-tpu-<link id>`` under the host's /dev whose *target* names
the physical card, so that the OCI hook resolves an allocation with
readlink alone. On an NVIDIA host the target is ``/dev/nvidia<minor>``.
Links target the minor, while annotations and the plugins' device ids use
the index. The contract lets the two differ (the stub permutes them, so
that tests catch a conflation); ``NvidiaOperator`` makes the index the
minor, which the driver keeps across the agent's restarts. A
:class:`GPUChip`'s ``device_path`` carries the minor, and :meth:`resolve`
maps a link's minor back to the index.

What the agent's operator does besides, and this copy does not: fire the
``operator.create``/``operator.delete`` failpoints and open the
``operator_create``/``operator_delete`` tracer spans. Both belong to the
agent's control plane (its fault-injection and tracing modules), which the
port does not import.
"""

from __future__ import annotations

import logging
import os
import re
import stat
import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional

logger = logging.getLogger(__name__)

# the agent's virtual node prefix (elastic_tpu_agent/common.py): the
# plugins build host paths /dev/elastic-tpu-<hash>-<p> with it
VirtualDevPrefix = "elastic-tpu-"

# the nodes every CUDA container needs besides its cards' own, under /dev
# (a card's ``extra_paths``)
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


def is_char_device(st) -> bool:
    """Whether a stat result names a character device a runtime can hand
    to a container: a host may hold a placeholder under a node's name (a
    regular file, or a node of major 0, which no driver owns)."""
    return stat.S_ISCHR(st.st_mode) and os.major(st.st_rdev) != 0


class OperatorError(Exception):
    pass


@dataclass(frozen=True)
class GPUChip:
    """One physical card as discovered on this host; the fields of the
    agent's ``TPUChip``."""

    uuid: str              # nvidia-smi's "GPU-..." id
    index: int             # the agent's card id (NvidiaOperator: minor)
    device_path: str       # host path of the node, "/dev/nvidia<minor>"
    hbm_bytes: int         # the card's memory
    cores: int             # streaming multiprocessors
    extra_paths: List[str] = field(default_factory=list)  # nvidiactl, uvm


class GPUOperator(ABC):
    """Physical device layer: discovery and the virtual node lifecycle."""

    # Whole-card operators set this False; the agent's plugin then hands
    # out the physical node paths at Allocate instead of virtual links.
    virtual_nodes: bool = True

    @abstractmethod
    def devices(self) -> List[GPUChip]:
        """This host's cards."""

    @abstractmethod
    def create(self, index: int, link_id: str) -> None:
        """Make the virtual node ``elastic-tpu-<link_id>`` -> card <index>."""

    @abstractmethod
    def delete(self, link_id: str) -> None:
        """Remove the virtual node; a missing node is not an error."""

    @abstractmethod
    def check(self, link_id: str) -> bool:
        """True when the virtual node exists."""

    def healthy_indexes(self) -> set:
        """Card indexes currently healthy. Default: every discovered card."""
        return {c.index for c in self.devices()}

    def health_reasons(self) -> dict:
        """Best effort {card index: why it is unhealthy}."""
        return {}

    def utilization(self) -> dict:
        """{card index: {"duty_cycle_percent": float, "hbm_used_bytes":
        int}}, or {"error": str} for a card whose read failed; an empty
        dict means this backend has no telemetry."""
        return {}

    def error_counters(self) -> dict:
        """Raw error counters {card index: {counter path: value}}."""
        return {}


# -- shared symlink mechanics -------------------------------------------------

_NVIDIA_RE = re.compile(r"nvidia(\d+)$")


def minor_from_target(target: str) -> Optional[int]:
    """The minor of a node path like "/dev/nvidia3"; None for any other."""
    m = _NVIDIA_RE.search(target)
    return int(m.group(1)) if m else None


class LinkingOperator(GPUOperator):
    """Base for operators that realize virtual devices as symlinks.

    ``dev_root`` is the host's /dev as mounted into the agent's container;
    link targets are host paths under ``target_root`` (/dev), which may
    dangle inside the agent's container: only the host-side hook resolves
    them.
    """

    def __init__(self, dev_root: str, target_root: str = "/dev") -> None:
        self._dev_root = dev_root
        self._target_root = target_root

    def link_path(self, link_id: str) -> str:
        return os.path.join(self._dev_root, VirtualDevPrefix + link_id)

    def node_path(self, minor: int) -> str:
        return os.path.join(self._target_root, f"nvidia{minor}")

    def minor_of(self, index: int) -> int:
        """The node minor of the card at ``index``."""
        for chip in self.devices():
            if chip.index == index:
                minor = minor_from_target(chip.device_path)
                if minor is not None:
                    return minor
        raise OperatorError(f"no card at index {index}")

    def index_of_minor(self, minor: int) -> Optional[int]:
        """The index of the card whose node has ``minor``; None if none."""
        for chip in self.devices():
            if minor_from_target(chip.device_path) == minor:
                return chip.index
        return None

    def target_path(self, index: int) -> str:
        return self.node_path(self.minor_of(index))

    def create(self, index: int, link_id: str) -> None:
        """Crash-atomic, idempotent create with verify-after-write.

        The link is made under a temp name and renamed into place, so no
        crash leaves a half-made or wrong-target link at the final path;
        a leaked temp carries the virtual prefix, so the agent's orphan
        sweep reclaims it. Re-creating a correct link is a no-op."""
        link = self.link_path(link_id)
        target = self.target_path(index)
        try:
            if os.path.islink(link) and os.readlink(link) == target:
                return
            # unique per process and thread: a repair and a rebind of the
            # same link id may race
            tmp = f"{link}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            os.symlink(target, tmp)
            os.replace(tmp, link)
        except OSError as e:
            raise OperatorError(f"create {link} -> {target}: {e}") from e
        try:
            back = os.readlink(link)
        except OSError as e:
            raise OperatorError(
                f"create {link}: verify-after-write failed: {e}") from e
        if back != target:
            raise OperatorError(
                f"create {link}: verify-after-write mismatch "
                f"({back!r} != {target!r})")
        logger.info("created virtual GPU node %s -> %s", link, target)

    def delete(self, link_id: str) -> None:
        """Idempotent delete (a missing link is success), verified."""
        link = self.link_path(link_id)
        try:
            os.unlink(link)
            logger.info("removed virtual GPU node %s", link)
        except FileNotFoundError:
            pass
        except OSError as e:
            raise OperatorError(f"delete {link}: {e}") from e
        if os.path.islink(link):
            raise OperatorError(f"delete {link}: link still present")

    def check(self, link_id: str) -> bool:
        return os.path.islink(self.link_path(link_id))

    def resolve(self, link_id: str) -> Optional[int]:
        """The card index a virtual node points at (through its target's
        minor), or None."""
        try:
            minor = minor_from_target(os.readlink(self.link_path(link_id)))
        except OSError:
            return None
        return None if minor is None else self.index_of_minor(minor)

    def list_links(self) -> List[str]:
        """Every virtual-node link id present (the agent's restore/GC)."""
        try:
            names = os.listdir(self._dev_root)
        except OSError:
            return []
        return [n[len(VirtualDevPrefix):] for n in names
                if n.startswith(VirtualDevPrefix)]

"""The container injection of a CUDA allocation: what the NRI plugin adds
at container create.

Counterpart of ``elastic_tpu_agent/nri/plugin.py``'s ``hash_from_env`` and
``adjustment_from_spec``. containerd does not read OCI hooks.d, so the
agent answers NRI's CreateContainer with a ContainerAdjustment carrying
what the allocation spec (``plugins/gpushare.py``) records:

- one character device a bound card at its host name ``/dev/nvidia<minor>``
  (the driver opens the minor the kernel reports, so the agent's dense
  ``/dev/accel<p>`` renumbering is not carried over), with major:minor
  from ``stat`` of the host node;
- the control nodes a CUDA process opens (``/dev/nvidiactl``,
  ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``): those the spec's
  ``control_paths`` names, which the operator found as character devices
  at discovery;
- the spec's env, ``CUDA_VISIBLE_DEVICES`` and the quota included;
- a read-only bind mount of the spec file.

:func:`plain_adjustment` builds it as plain data and imports no protobuf;
:func:`adjustment_from_spec` turns it into the ``nri_pb2`` message. The
``NRIPlugin`` server (ttrpc over the runtime's socket) waits for a later
slice.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from ..common import EnvAllocationHash, EnvAllocationHashCompat
from ..device.operator import is_char_device

# Where the spec file lands inside the container.
SPEC_MOUNT_DEST = "/run/elastic-tpu/spec.json"
HASH_ANNOTATION = "elastic-tpu.elasticgpu.io/hash"
DEVICE_FILE_MODE = 0o660

_BIND_OPTS = ["bind", "ro", "nosuid", "nodev"]


def hash_from_env(env: List[str]) -> Optional[str]:
    """The allocation hash in a container's env (``TPU=<hash>``, or the
    reference's ``GPU=<hash>``)."""
    for key in (EnvAllocationHash + "=", EnvAllocationHashCompat + "="):
        for entry in env:
            if entry.startswith(key):
                value = entry[len(key):]
                if value:
                    return value
    return None


def plain_adjustment(
    spec: Dict,
    stat_fn: Callable = os.stat,
    dev_root: str = "/dev",
    spec_path: str = "",
) -> Dict:
    """The adjustment for one spec, as plain data: ``annotations``,
    ``devices`` (dicts of path, type, major, minor, file_mode), ``env``
    ((key, value) pairs, sorted) and ``mounts``.

    ``dev_root`` maps the host's /dev into this process's view (the agent
    sees it at /host/dev in its DaemonSet): the nodes are stat'ed there and
    named by their host paths. A card node that does not stat as a
    character device fails the adjustment; a control node that does not
    (gone since discovery) is left out."""

    def view(host_path: str) -> str:
        if dev_root != "/dev" and host_path.startswith("/dev/"):
            return os.path.join(dev_root, host_path[len("/dev/"):])
        return host_path

    def device(path: str, st) -> Dict:
        return dict(path=path, type="c", major=os.major(st.st_rdev),
                    minor=os.minor(st.st_rdev), file_mode=DEVICE_FILE_MODE)

    devices = []
    for path in spec.get("device_paths", []):
        st = stat_fn(view(path))
        if not is_char_device(st):
            raise ValueError(f"card node {path} is not a character device")
        devices.append(device(path, st))
    for path in spec.get("control_paths", []):
        try:
            st = stat_fn(view(path))
        except FileNotFoundError:
            continue
        if is_char_device(st):
            devices.append(device(path, st))
    env = spec.get("env", {})
    mounts = []
    if spec_path:
        mounts.append(dict(destination=SPEC_MOUNT_DEST, type="bind",
                           source=spec_path, options=list(_BIND_OPTS)))
    return dict(
        annotations={HASH_ANNOTATION: spec.get("hash", "")},
        devices=devices,
        env=[(k, env[k]) for k in sorted(env)],
        mounts=mounts,
    )


def adjustment_from_spec(
    spec: Dict,
    stat_fn: Callable = os.stat,
    dev_root: str = "/dev",
    spec_path: str = "",
):
    """:func:`plain_adjustment` as an ``nri_pb2.ContainerAdjustment``."""
    from ..gen import nri_pb2 as pb

    plain = plain_adjustment(spec, stat_fn=stat_fn, dev_root=dev_root,
                             spec_path=spec_path)
    adjust = pb.ContainerAdjustment()
    adjust.annotations.update(plain["annotations"])
    for d in plain["devices"]:
        adjust.linux.devices.append(pb.LinuxDevice(
            path=d["path"], type=d["type"], major=d["major"],
            minor=d["minor"],
            file_mode=pb.OptionalFileMode(value=d["file_mode"])))
    for key, value in plain["env"]:
        adjust.env.append(pb.KeyValue(key=key, value=value))
    for m in plain["mounts"]:
        adjust.mounts.append(pb.Mount(**m))
    return adjust

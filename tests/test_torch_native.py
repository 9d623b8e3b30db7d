"""The port's OCI hook chain (``elastic_tpu_agent_torch/native``):
``tests/test_native.py``'s cases carried over to ``elastic-gpu-hook``,
``elastic-gpu-container-toolkit`` and ``mount_elastic_gpu``, built once for
the module by ``native/build.py`` into a temp dir, and driven as the
container runtime drives them: the OCI state on stdin, a bundle's
config.json, an allocation spec or the agent's links under a fake host
/dev.

The fake host /dev holds ``nvidia<minor>`` and the control nodes as
symlinks to real character devices (/dev/null, /dev/zero, /dev/full): a
node is injected by its major:minor, so any character device proves the
mechanism. The toolkit's injected device set and env are held equal to
``nri.plain_adjustment``'s for the same spec, and the dev-scan fallback's
to the spec's: the same nodes, the card's uuid from a fake
``/proc/driver/nvidia``.
"""

import json
import os
import shutil
import stat
import subprocess
import tempfile

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent_torch.native import build as native_build  # noqa: E402
from elastic_tpu_agent_torch.nri import plain_adjustment  # noqa: E402

UUID = "GPU-5b6c7d8e-1111-2222-3333-444455556666"
# the fake host's nodes: name -> the real character device it stands for
HOST_NODES = {"nvidia3": "/dev/null", "nvidiactl": "/dev/zero",
              "nvidia-uvm": "/dev/full"}
CONTROL = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
SPEC_ENV = {"CUDA_VISIBLE_DEVICES": UUID, "ELASTIC_TPU_CORE_UNITS": "25",
            "ELASTIC_TPU_HBM_LIMIT_BYTES": str(20 << 30),
            "ELASTIC_TPU_TRACE_ID": "0123456789abcdef"}


@pytest.fixture(scope="module")
def bins():
    out = tempfile.mkdtemp(prefix="nb", dir="/tmp")
    yield native_build.build(out)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture
def host(tmp_path):
    """A fake host: /dev (nodes and links), an alloc dir, a /proc."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name, real in HOST_NODES.items():
        os.symlink(real, dev / name)
    alloc = tmp_path / "alloc"
    alloc.mkdir()
    proc = tmp_path / "proc"
    info = proc / "driver" / "nvidia" / "gpus" / "0000:19:00.0"
    info.mkdir(parents=True)
    (info / "information").write_text(
        "Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 215\n"
        f"GPU UUID: \t {UUID}\nVideo BIOS: \t 96.00.74.00.01\n"
        "Bus Type: \t PCIe\nDevice Minor: \t 3\nGPU Excluded:\t No\n")
    return dict(dev=str(dev), alloc=str(alloc), proc=str(proc),
                root=tmp_path)


def make_bundle(tmp_path, env=None, rootfs_name="rootfs"):
    bundle = tmp_path / "bundle"
    rootfs = bundle / rootfs_name
    (rootfs / "dev").mkdir(parents=True)
    (bundle / "config.json").write_text(json.dumps({
        "ociVersion": "1.0.2", "process": {"env": env or []},
        "root": {"path": rootfs_name}}))
    return bundle, rootfs


def write_spec(host, alloc_hash, device_paths=("/dev/nvidia3",),
               control_paths=CONTROL, env=SPEC_ENV):
    spec = {"hash": alloc_hash, "resource": "elasticgpu.io/gpu-core",
            "chip_indexes": [3], "device_paths": list(device_paths),
            "control_paths": list(control_paths), "env": dict(env)}
    path = os.path.join(host["alloc"], f"{alloc_hash}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec, path


def run_hook(bins, bundle, host=None, extra_env=None):
    state = json.dumps({"ociVersion": "1.0.2", "id": "c1", "pid": 1,
                        "bundle": str(bundle)})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ELASTIC_GPU_")}
    env["ELASTIC_GPU_TOOLKIT"] = bins["elastic-gpu-container-toolkit"]
    if host is not None:
        env.update(ELASTIC_GPU_ALLOC_DIR=host["alloc"],
                   ELASTIC_GPU_DEV_DIR=host["dev"],
                   ELASTIC_GPU_PROC_ROOT=host["proc"])
    env.update(extra_env or {})
    return subprocess.run([bins["elastic-gpu-hook"], "--verbose"],
                          input=state.encode(), env=env,
                          capture_output=True, timeout=30)


def injected(rootfs) -> dict:
    """{container path: (major, minor)} of the character devices in the
    rootfs's /dev."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(rootfs, "dev")):
        for name in files:
            path = os.path.join(dirpath, name)
            st = os.lstat(path)
            if stat.S_ISCHR(st.st_mode):
                rel = "/" + os.path.relpath(path, rootfs)
                out[rel] = (os.major(st.st_rdev), os.minor(st.st_rdev))
    return out


def env_file(rootfs) -> dict:
    text = (rootfs / "run" / "elastic-tpu" / "env").read_text()
    return dict(line.split("=", 1) for line in text.splitlines())


def rdev(path):
    st = os.stat(path)
    return (os.major(st.st_rdev), os.minor(st.st_rdev))


# -- the hook -----------------------------------------------------------------


def test_hook_passthrough_without_hash_env(bins, tmp_path):
    bundle, rootfs = make_bundle(tmp_path, env=["PATH=/bin", "TPU="])
    result = run_hook(bins, bundle)
    assert result.returncode == 0, result.stderr
    assert os.listdir(rootfs / "dev") == []


def test_hook_malformed_state_fails_loudly(bins):
    result = subprocess.run([bins["elastic-gpu-hook"]], input=b"not json",
                            capture_output=True)
    assert result.returncode == 1
    assert b"malformed" in result.stderr


def test_hook_without_bundle_fails(bins):
    result = subprocess.run([bins["elastic-gpu-hook"]], input=b'{"id": "c"}',
                            capture_output=True)
    assert result.returncode == 1
    assert b"no bundle path" in result.stderr


# -- hook -> toolkit from the spec --------------------------------------------


def test_hook_injects_the_spec_at_host_names(bins, host, tmp_path):
    """The card at /dev/nvidia3 with the host node's rdev, the control
    nodes the host holds (nvidia-uvm-tools is gone and left out), the
    spec's env in /run/elastic-tpu/env and the spec's copy."""
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=cafe1234"])
    write_spec(host, "cafe1234")
    result = run_hook(bins, bundle, host)
    assert result.returncode == 0, result.stderr.decode()
    assert injected(rootfs) == {"/dev/nvidia3": rdev("/dev/null"),
                                "/dev/nvidiactl": rdev("/dev/zero"),
                                "/dev/nvidia-uvm": rdev("/dev/full")}
    assert env_file(rootfs) == SPEC_ENV
    copy = json.loads((rootfs / "run" / "elastic-tpu" / "alloc.json")
                      .read_text())
    assert copy["device_paths"] == ["/dev/nvidia3"]


def test_toolkit_injects_what_the_nri_adjustment_injects(bins, host,
                                                         tmp_path):
    """For one spec, the hook chain and the NRI server inject the same
    device set (path and major:minor) and the same env."""
    bundle, rootfs = make_bundle(tmp_path, env=["GPU=beef0001"])
    spec, path = write_spec(host, "beef0001")
    assert run_hook(bins, bundle, host).returncode == 0
    adj = plain_adjustment(spec, stat_fn=os.stat, dev_root=host["dev"],
                           spec_path=path)
    assert injected(rootfs) == {d["path"]: (d["major"], d["minor"])
                                for d in adj["devices"]}
    assert env_file(rootfs) == dict(adj["env"])
    assert [d["file_mode"] for d in adj["devices"]] == [0o660] * 3


def test_toolkit_idempotent_rerun(bins, host, tmp_path):
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=beef5678"])
    write_spec(host, "beef5678")
    for _ in range(2):  # prestart may run after createRuntime did
        result = run_hook(bins, bundle, host)
        assert result.returncode == 0, result.stderr.decode()
    assert rdev(rootfs / "dev" / "nvidia3") == rdev("/dev/null")


def test_gpu_env_compat(bins, host, tmp_path):
    bundle, rootfs = make_bundle(tmp_path, env=["GPU=00c0ffee"])
    write_spec(host, "00c0ffee")
    result = run_hook(bins, bundle, host)
    assert result.returncode == 0, result.stderr.decode()
    assert (rootfs / "dev" / "nvidia3").exists()


def test_a_card_node_that_is_no_device_fails(bins, host, tmp_path):
    (host["root"] / "dev" / "nvidia5").write_text("")
    bundle, _ = make_bundle(tmp_path, env=["TPU=0bad0bad"])
    write_spec(host, "0bad0bad", device_paths=["/dev/nvidia5"])
    result = run_hook(bins, bundle, host)
    assert result.returncode == 1
    assert b"not a character device" in result.stderr


def test_missing_allocation_fails(bins, host, tmp_path):
    bundle, _ = make_bundle(tmp_path, env=["TPU=deadbeef"])
    result = run_hook(bins, bundle, host)
    assert result.returncode == 1
    assert b"no allocation found" in result.stderr


def test_hostile_hash_cannot_escape_alloc_dir(bins, host, tmp_path):
    spec, _ = write_spec(host, "evil")
    os.replace(os.path.join(host["alloc"], "evil.json"),
               os.path.join(host["root"], "evil.json"))
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=../evil"])
    result = run_hook(bins, bundle, host)
    assert result.returncode == 1
    assert injected(rootfs) == {}


# -- the dev-scan fallback ----------------------------------------------------


def test_devscan_injects_the_specs_nodes_and_uuid(bins, host, tmp_path):
    """The spec moved away: the agent's link to /dev/nvidia3 gives the
    same nodes as the spec, and CUDA_VISIBLE_DEVICES the card's uuid from
    the driver's proc file."""
    spec, path = write_spec(host, "77ee66dd")
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=77ee66dd"])
    assert run_hook(bins, bundle, host).returncode == 0
    want_nodes = injected(rootfs)
    os.unlink(path)
    os.symlink("/dev/nvidia3", os.path.join(host["dev"],
                                            "elastic-tpu-77ee66dd-0"))
    bundle2, rootfs2 = make_bundle(tmp_path / "scan", env=["TPU=77ee66dd"])
    result = run_hook(bins, bundle2, host)
    assert result.returncode == 0, result.stderr.decode()
    assert injected(rootfs2) == want_nodes
    assert env_file(rootfs2) == {"CUDA_VISIBLE_DEVICES": UUID}


def test_devscan_orders_links_by_position(bins, host, tmp_path):
    """Two links: position 0 first; the second card's node is missing on
    the host, so the run fails naming it after injecting the first."""
    info = os.path.join(host["proc"], "driver", "nvidia", "gpus", "b")
    os.makedirs(info)
    with open(os.path.join(info, "information"), "w") as f:
        f.write("GPU UUID: GPU-second\nDevice Minor: 7\n")
    os.symlink("/dev/nvidia7", os.path.join(host["dev"],
                                            "elastic-tpu-12ab34cd-1"))
    os.symlink("/dev/nvidia3", os.path.join(host["dev"],
                                            "elastic-tpu-12ab34cd-0"))
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=12ab34cd"])
    result = run_hook(bins, bundle, host)
    assert result.returncode == 1
    assert b"nvidia7" in result.stderr
    assert "/dev/nvidia3" in injected(rootfs)


@pytest.mark.parametrize("target", [
    "/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools",
    "/dev/nvidia-modeset", "/dev/nvidia-caps/nvidia-cap1", "/dev/nvidia",
    "/dev/nvidia3x"])
def test_devscan_never_takes_a_control_node_for_a_card(bins, host, tmp_path,
                                                       target):
    os.symlink(target, os.path.join(host["dev"], "elastic-tpu-c0ffee00-0"))
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=c0ffee00"])
    result = run_hook(bins, bundle, host)
    assert result.returncode == 1
    assert b"no allocation found" in result.stderr
    assert injected(rootfs) == {}


def test_devscan_without_a_uuid_fails_rather_than_emit_an_ordinal(
        bins, host, tmp_path):
    shutil.rmtree(os.path.join(host["proc"], "driver"))
    os.symlink("/dev/nvidia3", os.path.join(host["dev"],
                                            "elastic-tpu-a1b2c3d4-0"))
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=a1b2c3d4"])
    result = run_hook(bins, bundle, host, extra_env={
        "ELASTIC_GPU_NVIDIA_SMI": str(tmp_path / "no-nvidia-smi")})
    assert result.returncode == 1
    assert b"no uuid for card minor 3" in result.stderr
    assert not (rootfs / "run" / "elastic-tpu" / "env").exists()


SMI_XML = """<?xml version="1.0" ?>
<nvidia_smi_log>
  <gpu id="00000000:18:00.0">
    <product_name>NVIDIA H100 80GB HBM3</product_name>
    <mig_devices>
      <mig_device><uuid>MIG-decoy</uuid><minor_number>3</minor_number>
      </mig_device>
    </mig_devices>
    <uuid>GPU-other</uuid>
    <minor_number>0</minor_number>
  </gpu>
  <gpu id="00000000:19:00.0">
    <product_name>NVIDIA H100 80GB HBM3</product_name>
    <uuid>%s</uuid>
    <minor_number>3</minor_number>
  </gpu>
</nvidia_smi_log>
"""


def test_devscan_asks_nvidia_smi_where_proc_hides_the_uuids(bins, host,
                                                            tmp_path):
    """A container may hide /proc/driver/nvidia/gpus: the uuid then comes
    from nvidia-smi -q -x, matched by minor, a MIG device's entries aside."""
    shutil.rmtree(os.path.join(host["proc"], "driver"))
    smi = tmp_path / "nvidia-smi"
    (tmp_path / "smi.xml").write_text(SMI_XML % UUID)
    smi.write_text(f"#!/bin/sh\n[ \"$1 $2\" = \"-q -x\" ] || exit 9\n"
                   f"cat {tmp_path / 'smi.xml'}\n")
    smi.chmod(0o755)
    os.symlink("/dev/nvidia3", os.path.join(host["dev"],
                                            "elastic-tpu-5a5a5a5a-0"))
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=5a5a5a5a"])
    result = run_hook(bins, bundle, host,
                      extra_env={"ELASTIC_GPU_NVIDIA_SMI": str(smi)})
    assert result.returncode == 0, result.stderr.decode()
    assert env_file(rootfs) == {"CUDA_VISIBLE_DEVICES": UUID}
    assert "/dev/nvidia3" in injected(rootfs)


# -- driver libraries ---------------------------------------------------------


def test_driver_libs_copied_when_the_image_lacks_them(bins, host, tmp_path):
    lib = tmp_path / "hostlib" / "libcuda.so.1"
    lib.parent.mkdir()
    lib.write_bytes(b"\x7fELF-fake-libcuda")
    kept = tmp_path / "hostlib" / "libnvidia-ml.so.1"
    kept.write_bytes(b"\x7fELF-host-nvml")
    bundle, rootfs = make_bundle(tmp_path, env=["TPU=feedf00d"])
    image_copy = rootfs / str(kept).lstrip("/")
    image_copy.parent.mkdir(parents=True)
    image_copy.write_bytes(b"the image's own")
    write_spec(host, "feedf00d")
    result = run_hook(bins, bundle, host, extra_env={
        "ELASTIC_GPU_DRIVER_LIBS": f"{lib}::{kept}:/nonexistent/libx.so"})
    assert result.returncode == 0, result.stderr.decode()
    assert (rootfs / str(lib).lstrip("/")).read_bytes() == \
        b"\x7fELF-fake-libcuda"
    assert image_copy.read_bytes() == b"the image's own"
    assert not (rootfs / "nonexistent").exists()


# -- mount_elastic_gpu (attach to a running container) ------------------------


def test_mount_tool_attaches_into_mount_namespace(bins, tmp_path):
    """A process in its own mount namespace gets /dev/null as a card node,
    checked through its /proc root; a second attach finds it present."""
    import time

    if shutil.which("unshare") is None:
        pytest.skip("unshare not available")
    if subprocess.run(["unshare", "-m", "true"],
                      capture_output=True).returncode != 0:
        pytest.skip("mount namespaces not permitted here")
    victim = subprocess.Popen(["unshare", "-m", "sleep", "30"])
    try:
        # unshare execs sleep in place: the pid is the victim's once its
        # mount namespace differs from ours
        pid = str(victim.pid)
        ours = os.readlink("/proc/self/ns/mnt")
        deadline = time.monotonic() + 5
        while os.readlink(f"/proc/{pid}/ns/mnt") == ours:
            assert time.monotonic() < deadline, "no new mount namespace"
            time.sleep(0.01)
        tool = bins["mount_elastic_gpu"]
        target = str(tmp_path / "nvidia-target")
        result = subprocess.run([tool, pid, "/dev/null", target],
                                capture_output=True, text=True, timeout=10)
        assert result.returncode == 0, result.stderr
        st = os.stat(f"/proc/{pid}/root{target}")
        assert stat.S_ISCHR(st.st_mode)
        assert st.st_rdev == os.stat("/dev/null").st_rdev
        again = subprocess.run([tool, pid, "/dev/null", target],
                               capture_output=True, text=True, timeout=10)
        assert again.returncode == 0 and "already present" in again.stdout
        usage = subprocess.run([tool, pid, "/dev/null"], capture_output=True,
                               text=True)
        assert usage.returncode == 2
    finally:
        victim.kill()
        victim.wait()


# -- the builder --------------------------------------------------------------


def test_build_reuses_an_unchanged_tree(bins):
    mtimes = {k: os.stat(p).st_mtime_ns for k, p in bins.items()}
    again = native_build.build(os.path.dirname(os.path.dirname(
        bins["elastic-gpu-hook"])))
    assert again == bins
    assert {k: os.stat(p).st_mtime_ns for k, p in again.items()} == mtimes
    assert os.path.basename(os.path.dirname(bins["elastic-gpu-hook"])) == \
        native_build.digest()


def test_build_digests_the_sources_and_raises_on_failure(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native_build.SRC, src)
    monkeypatch.setattr(native_build, "SRC", src)
    monkeypatch.setattr(native_build, "BINARIES", {
        "elastic-gpu-hook": native_build.BINARIES["elastic-gpu-hook"]})
    before = native_build.digest()
    with open(src / "hook.cc", "a") as f:
        f.write("\nthis is not C++\n")
    assert native_build.digest() != before
    with pytest.raises(native_build.BuildError) as ei:
        native_build.build(str(tmp_path / "out"))
    assert "elastic-gpu-hook" in str(ei.value)
    out = tmp_path / "out" / native_build.digest()
    assert not (out / "elastic-gpu-hook").exists()

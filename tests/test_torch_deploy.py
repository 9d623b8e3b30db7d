"""The port's deployment files (``elastic_tpu_agent_torch/deploy``,
``native/install.sh``) stay consistent with the code they deploy, as
``tests/test_deploy.py`` holds the agent's: the DaemonSet's flags parse
with the port's CLI, its RBAC covers every call the port's apiserver
client makes (recorded against ``tests/fake_apiserver.py``), the CRD
manifest is the port's ``crd.py``'s, the Dockerfile copies files that
exist and builds the native sources ``native/build.py`` builds, and the
install script installs what the DaemonSet's init container runs.
"""

import json
import os
import re
import subprocess

import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from elastic_tpu_agent_torch.cli import parse_args  # noqa: E402
from elastic_tpu_agent_torch.native import build as native_build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "elastic_tpu_agent_torch")
DEPLOY = os.path.join(PKG, "deploy")
INSTALL = os.path.join(PKG, "native", "install.sh")
BINARIES = ("elastic-gpu-hook", "elastic-gpu-container-toolkit",
            "mount_elastic_gpu")


def _load(name):
    with open(os.path.join(DEPLOY, name)) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _kind(kind):
    return [d for d in _load("elastic-gpu-agent.yaml") if d["kind"] == kind]


def _pod_spec():
    (ds,) = _kind("DaemonSet")
    return ds["spec"]["template"]["spec"]


def _container(name):
    spec = _pod_spec()
    return next(c for c in spec.get("initContainers", []) +
                spec["containers"] if c["name"] == name)


def _agent_args():
    command = _container("agent")["command"]
    assert command[:3] == ["python3", "-m", "elastic_tpu_agent_torch.cli"]
    return command[3:]


def _dockerfile():
    with open(os.path.join(DEPLOY, "Dockerfile")) as f:
        text = f.read()
    # join continued lines
    return re.sub(r"\\\n\s*", " ", text)


def test_agent_args_parse_with_the_ports_cli():
    args = parse_args([a.replace("$(NODE_NAME)", "node-a")
                       for a in _agent_args()])
    assert (args.operator, args.plugin, args.nri_socket, args.dev_root,
            args.alloc_spec_dir, args.metrics_port) == (
        "nvidia", "gpushare", "/var/run/nri/nri.sock", "/host/dev",
        "/host/var/lib/elastic-tpu/alloc", 9478)


def test_the_agents_paths_are_mounted():
    """Every host path an argument names lies under a mount of the agent
    container, and each mount is a hostPath volume."""
    args = parse_args([a.replace("$(NODE_NAME)", "n") for a in
                       _agent_args()])
    mounts = {m["mountPath"]: m["name"]
              for m in _container("agent")["volumeMounts"]}
    volumes = {v["name"]: v["hostPath"]["path"] for v in
               _pod_spec()["volumes"]}
    for path in (args.db_file, args.dev_root, args.alloc_spec_dir,
                 args.nri_socket, args.device_plugin_dir,
                 args.pod_resources_socket):
        hit = [m for m in mounts if path == m or path.startswith(m + "/")]
        assert hit, path
    assert volumes[mounts["/host/dev"]] == "/dev"
    assert volumes[mounts["/var/run/nri"]] == "/var/run/nri"
    assert volumes[mounts["/host/var/lib/elastic-tpu"]] == \
        "/var/lib/elastic-tpu"


def test_gpu_node_match_uses_exists():
    spec = _pod_spec()
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    exprs = [e for t in terms for e in t["matchExpressions"]]
    assert exprs and all(e["operator"] == "Exists" for e in exprs)
    assert {"nvidia.com/gpu.present", "cloud.google.com/gke-accelerator"} \
        <= {e["key"] for e in exprs}
    assert {"key": "nvidia.com/gpu", "operator": "Exists"} in \
        spec["tolerations"]


def test_init_container_runs_the_installed_script():
    """The init container runs install.sh where the Dockerfile puts it,
    in the same image as the agent, with the host root mounted."""
    init = _container("install-host-binaries")
    assert init["image"] == _container("agent")["image"]
    (script,) = init["command"]
    docker = _dockerfile()
    workdir = re.findall(r"^WORKDIR (\S+)", docker, re.M)[-1]
    assert "COPY elastic_tpu_agent_torch/native/install.sh native/" in docker
    assert script == f"{workdir}/native/install.sh"
    env = {e["name"]: e["value"] for e in init["env"]}
    assert {m["mountPath"] for m in init["volumeMounts"]} == {
        env["HOST_ROOT"]}


def test_dockerfile_copies_files_that_exist_and_builds_the_ports_sources():
    docker = _dockerfile()
    for line in re.findall(r"^COPY (?!--from)(.+)$", docker, re.M):
        *sources, _ = line.split()
        for src in sources:
            assert os.path.exists(os.path.join(REPO, src)), src
    compiles = re.findall(r"(g\+\+|gcc) ((?:-\S+ )+)-o out/(\S+) ([^&\n]+)",
                          docker)
    built = {name: (cc, tuple(flags.split()),
                    tuple(os.path.basename(s) for s in srcs.split()))
             for cc, flags, name, srcs in compiles}
    assert built == {name: (cc, native_build._flags(cc), srcs)
                     for name, (cc, srcs) in native_build.BINARIES.items()}
    copied = re.search(r"COPY --from=native-build (.+) native/", docker)
    assert sorted(os.path.basename(p) for p in copied.group(1).split()) == \
        sorted(BINARIES)
    entry = json.loads(re.search(r"^ENTRYPOINT (.+)$", docker,
                                 re.M).group(1))
    assert entry == ["python3", "-m", "elastic_tpu_agent_torch.cli"]
    import importlib

    assert importlib.import_module("elastic_tpu_agent_torch.cli").main


def test_crd_manifest_matches_the_ports_client():
    from elastic_tpu_agent_torch import crd

    (doc,) = _load("elastic-tpu-crd.yaml")
    assert doc["spec"]["group"] == crd.GROUP
    names = doc["spec"]["names"]
    assert (names["plural"], names["kind"]) == (crd.PLURAL, crd.KIND)
    served = next(v for v in doc["spec"]["versions"]
                  if v["name"] == crd.VERSION)
    assert served.get("subresources", {}).get("status") is not None


def _verb(method, path, params):
    """(api group, resource, verb) of one request the client made."""
    parts = path.strip("/").split("/")
    if parts[0] == "api":
        group, rest = "", parts[2:]
    else:
        group, rest = parts[1], parts[3:]
    if rest[0] == "namespaces":
        rest = rest[2:]
    resource = rest[0]
    if len(rest) == 3:
        resource += "/" + rest[2]
    named = len(rest) >= 2
    verb = {"GET": "get" if named else "list", "POST": "create",
            "PUT": "update", "PATCH": "patch", "DELETE": "delete"}[method]
    if (params or {}).get("watch") == "true":
        verb = "watch"
    return group, resource, verb


def test_rbac_covers_every_call_of_the_ports_client():
    """The port's KubeClient and ElasticTPUClient drive every request they
    make against the fake apiserver; each is allowed by the ClusterRole."""
    from elastic_tpu_agent_torch import crd
    from elastic_tpu_agent_torch.kube.client import KubeClient

    from fake_apiserver import FakeAPIServer, make_pod

    api = FakeAPIServer()
    url = api.start()
    seen = set()
    client = KubeClient(url)
    opened = client._open

    def record(method, path, params=None, *a, **kw):
        seen.add(_verb(method, path, params))
        return opened(method, path, params, *a, **kw)

    client._open = record
    try:
        api.add_node("node-a")
        api.upsert_pod(make_pod("default", "p", "node-a"))
        client.get_pod("default", "p")
        client.get_node("node-a")
        client.list_pods("node-a")
        api.upsert_pod(make_pod("default", "q", "node-a"))
        next(client.watch_pods("node-a", "0", timeout_s=1))
        client.create_event("default", {
            "metadata": {"generateName": "x."}, "reason": "TPUBound",
            "involvedObject": {"kind": "Pod", "name": "p"}})
        tpus = crd.ElasticTPUClient(client)
        obj = crd.ElasticTPU(name="node-a-h", node_name="node-a",
                             phase="Bound")
        tpus.create(obj)
        tpus.create(obj)                 # exists: update
        tpus.get("node-a-h")
        tpus.list("node-a")
        tpus.delete("node-a-h")
    finally:
        api.stop()
    rules = [r for role in _kind("ClusterRole") for r in role["rules"]]

    def allowed(group, resource, verb):
        return any(group in r["apiGroups"] and resource in r["resources"]
                   and verb in r["verbs"] for r in rules)

    assert {v for v in seen if not allowed(*v)} == set()
    assert ("elasticgpu.io", "elastictpus/status", "update") in seen
    assert ("", "pods", "watch") in seen
    (binding,) = _kind("ClusterRoleBinding")
    (sa,) = _kind("ServiceAccount")
    assert binding["roleRef"]["name"] == _kind("ClusterRole")[0][
        "metadata"]["name"]
    assert binding["subjects"][0]["name"] == sa["metadata"]["name"] == \
        _pod_spec()["serviceAccountName"]


# -- install.sh ---------------------------------------------------------------


def _install(tmp_path, **env):
    stage = tmp_path / "bin"
    stage.mkdir(exist_ok=True)
    for name in BINARIES:
        (stage / name).write_text("#!/bin/sh\n")
    host = tmp_path / "host"
    result = subprocess.run(
        ["sh", INSTALL], capture_output=True, text=True, timeout=60,
        env={**os.environ, "HOST_ROOT": str(host), "BIN_DIR": str(stage),
             **env})
    return host, result


def test_install_sh_installs_the_chain_and_its_hooks_d_entry(tmp_path):
    host, result = _install(tmp_path)
    assert result.returncode == 0, result.stderr
    for name in BINARIES:
        path = host / "usr" / "local" / "bin" / name
        assert os.access(path, os.X_OK), name
    entry = json.loads((host / "usr" / "share" / "containers" / "oci" /
                        "hooks.d" / "10-elastic-gpu.json").read_text())
    assert entry["hook"] == {"path": "/usr/local/bin/elastic-gpu-hook"}
    assert entry["stages"] == ["createRuntime", "prestart"]
    assert entry["when"] == {"env": ["TPU=.*", "GPU=.*"]}


def test_install_sh_passes_driver_libs_to_the_hook(tmp_path):
    libs = "/usr/lib/x86_64-linux-gnu/libcuda.so.1:/usr/lib/libnvidia-ml.so.1"
    host, result = _install(tmp_path, DRIVER_LIBS=libs, SKIP_BINARIES="1")
    assert result.returncode == 0, result.stderr
    assert not (host / "usr" / "local" / "bin").exists()
    entry = json.loads((host / "usr" / "share" / "containers" / "oci" /
                        "hooks.d" / "10-elastic-gpu.json").read_text())
    assert entry["hook"]["env"] == [f"ELASTIC_GPU_DRIVER_LIBS={libs}"]


@pytest.mark.parametrize("before,expect", [
    (None, "created"),
    ('version = 2\n[plugins."io.containerd.grpc.v1.cri"]\n', "enabled"),
    ('version = 2\n[plugins."io.containerd.nri.v1.nri"]\n  disable = true\n'
     '  disable_connections = true\n[plugins."x"]\n  keep = true\n',
     "flipped"),
    ('[plugins."io.containerd.nri.v1.nri"]\n  disable = false\n',
     "already enabled"),
])
def test_install_sh_enables_nri_in_every_config_state(tmp_path, before,
                                                      expect):
    conf = tmp_path / "host" / "etc" / "containerd" / "config.toml"
    if before is not None:
        conf.parent.mkdir(parents=True)
        conf.write_text(before)
    host, result = _install(tmp_path, ENABLE_NRI="1")
    assert result.returncode == 0, result.stderr
    assert expect in result.stdout
    raw = conf.read_text()
    section = raw[raw.index("io.containerd.nri.v1.nri"):]
    assert "disable = false" in section and "disable = true" not in raw
    if before and "keep = true" in before:
        assert "keep = true" in raw


def test_the_image_and_the_installer_name_the_built_binaries():
    """The Dockerfile's stage, build.py and install.sh name the same three
    binaries."""
    with open(INSTALL) as f:
        script = f.read()
    for name in BINARIES:
        assert name in native_build.BINARIES
        assert name in script

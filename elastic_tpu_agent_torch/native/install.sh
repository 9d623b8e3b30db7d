#!/bin/sh
# Host installer of the port's OCI hook chain (the agent's native/install.sh
# in CUDA form): install elastic-gpu-hook, elastic-gpu-container-toolkit and
# mount_elastic_gpu under $HOST_ROOT/usr/local/bin and register the hook as
# an OCI createRuntime/prestart hook in hooks.d (read by CRI-O and podman).
#
# Run from the DaemonSet's init container with the host filesystem mounted
# at $HOST_ROOT (default /host). The binaries are taken from $BIN_DIR
# (default: this script's directory). Optional:
#   DRIVER_LIBS=/usr/lib/x86_64-linux-gnu/libcuda.so.1:...  host driver
#       libraries the toolkit copies into images that lack them
#   SKIP_BINARIES=1  install no binary (a read-only /usr: use the agent's NRI
#       path, --nri-socket, which needs none)
#   ENABLE_NRI=1     enable NRI in containerd's config.toml (containerd does
#       not read hooks.d; the agent injects through NRI there)
set -e
HOST_ROOT="${HOST_ROOT:-/host}"
BIN_DIR="${BIN_DIR:-$(dirname "$0")}"

if [ "${SKIP_BINARIES:-0}" != "1" ]; then
    mkdir -p "$HOST_ROOT/usr/local/bin"
    for bin in elastic-gpu-hook elastic-gpu-container-toolkit \
               mount_elastic_gpu; do
        install -m 0755 "$BIN_DIR/$bin" "$HOST_ROOT/usr/local/bin/$bin"
    done
fi

HOOK_DIR="$HOST_ROOT/usr/share/containers/oci/hooks.d"
mkdir -p "$HOOK_DIR"
HOOK_ENV=""
if [ -n "${DRIVER_LIBS:-}" ]; then
    HOOK_ENV=", \"env\": [\"ELASTIC_GPU_DRIVER_LIBS=$DRIVER_LIBS\"]"
fi
cat > "$HOOK_DIR/10-elastic-gpu.json" <<JSON
{
  "version": "1.0.0",
  "hook": {"path": "/usr/local/bin/elastic-gpu-hook"$HOOK_ENV},
  "when": {"env": ["TPU=.*", "GPU=.*"]},
  "stages": ["createRuntime", "prestart"]
}
JSON

if [ "${ENABLE_NRI:-0}" = "1" ]; then
    # runs under the agent image, so python3 exists
    python3 - "$HOST_ROOT/etc/containerd/config.toml" <<'PYEOF'
import os, re, shutil, sys
conf = sys.argv[1]
SECTION = '[plugins."io.containerd.nri.v1.nri"]'
BLOCK = ("\n# added by the elastic-gpu installer: NRI for device injection\n"
         + SECTION + "\n  disable = false\n  disable_connections = false\n"
         '  socket_path = "/var/run/nri/nri.sock"\n')
if not os.path.exists(conf):
    os.makedirs(os.path.dirname(conf), exist_ok=True)
    with open(conf, "w") as f:
        f.write("version = 2\n" + BLOCK)
    print(f"created {conf} with NRI enabled; restart containerd")
    sys.exit(0)
raw = open(conf).read()
if "io.containerd.nri.v1.nri" not in raw:
    shutil.copy(conf, conf + ".elastic-gpu.bak")
    with open(conf, "a") as f:
        f.write(BLOCK)
    print(f"enabled NRI in {conf}; restart containerd")
    sys.exit(0)
start = raw.index("io.containerd.nri.v1.nri")
m = re.search(r"\n\s*\[", raw[start:])
end = start + (m.start() if m else len(raw) - start)
section = raw[start:end]
flipped = re.sub(r"(disable(?:_connections)?\s*=\s*)true", r"\1false",
                 section)
if flipped == section:
    print(f"NRI already enabled in {conf}; nothing to do")
    sys.exit(0)
shutil.copy(conf, conf + ".elastic-gpu.bak")
with open(conf, "w") as f:
    f.write(raw[:start] + flipped + raw[end:])
print(f"flipped NRI disable -> false in {conf}; restart containerd")
PYEOF
fi

echo "elastic-gpu host helpers installed under $HOST_ROOT/usr/local/bin"

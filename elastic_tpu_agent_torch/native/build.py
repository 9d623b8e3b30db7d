"""Build the port's native host helpers from the sources beside this file.

``elastic-gpu-hook`` (``hook.cc``), ``elastic-gpu-container-toolkit``
(``toolkit.cc``), both with ``json.cc``, and ``mount_elastic_gpu``
(``mount_elastic_gpu.c``) compile with ``g++``/``gcc``, one process each,
started together, into ``<out>/<digest>/``, where the digest covers every
source, the header and the flags: an edited source rebuilds, an unchanged
tree is reused. ``out`` defaults to ``_build/native/`` of the package,
which git ignores. A failed build raises with the compiler's output.

Run ``python3 -m elastic_tpu_agent_torch.native.build [--out DIR]``: it
prints ``{name: path}`` as JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).resolve().parent
BUILD_DIR = SRC.parent / "_build" / "native"
CXXFLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17")
CFLAGS = ("-O2", "-Wall", "-Wextra")
# binary -> (compiler, its sources)
BINARIES = {
    "elastic-gpu-hook": ("g++", ("hook.cc", "json.cc")),
    "elastic-gpu-container-toolkit": ("g++", ("toolkit.cc", "json.cc")),
    "mount_elastic_gpu": ("gcc", ("mount_elastic_gpu.c",)),
}
HEADERS = ("json.h",)


class BuildError(RuntimeError):
    pass


def _flags(compiler: str) -> tuple:
    return CXXFLAGS if compiler == "g++" else CFLAGS


def digest() -> str:
    h = hashlib.sha256()
    for name in sorted({s for _, srcs in BINARIES.values() for s in srcs}
                       | set(HEADERS)):
        h.update(name.encode() + b"\0" + (SRC / name).read_bytes())
    for name, (compiler, srcs) in sorted(BINARIES.items()):
        h.update(" ".join((name, compiler, *srcs,
                           *_flags(compiler))).encode())
    return h.hexdigest()[:16]


def build(out: Optional[str] = None) -> Dict[str, str]:
    """Compile the binaries that ``<out>/<digest>/`` lacks (in parallel);
    returns {binary name: path}."""
    target = (Path(out) if out else BUILD_DIR) / digest()
    target.mkdir(parents=True, exist_ok=True)
    paths = {name: target / name for name in BINARIES}
    jobs = []
    for name, (compiler, srcs) in BINARIES.items():
        if paths[name].exists():
            continue
        tmp = target / f".{name}.{os.getpid()}.tmp"
        cmd = [compiler, *_flags(compiler), "-o", str(tmp),
               *(str(SRC / s) for s in srcs)]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise BuildError("native helper build failed:\n" + "\n".join(failed))
    return {name: str(p) for name, p in paths.items()}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m "
                                "elastic_tpu_agent_torch.native.build")
    p.add_argument("--out", default=None,
                   help=f"build root (default {BUILD_DIR})")
    args = p.parse_args(argv)
    print(json.dumps(build(args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

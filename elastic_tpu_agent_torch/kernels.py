"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). All sources build at
once, one ``nvcc`` process each, started together, the first time any
kernel is launched. Libraries land in ``_build/`` beside this file, named
by a digest of their source, the shared headers (``csrc/*.cuh``, which
every source may include) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. Each build's compiler output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside its
library as ``.log``.

Nothing here runs at import: the CPU-only test environment imports every
module of the port and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current library (in parallel),
    then load them all; returns {source stem: CDLL}. Raises with the
    compiler's output if any build fails."""
    with _lock:
        if _libs:
            return _libs
        sources = sorted(CSRC.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sources:
            lib = _library_path(src)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((src, lib, tmp, proc))
        failed = []
        for src, lib, tmp, proc in jobs:
            text, _ = proc.communicate()
            lib.with_suffix(".log").write_text(text)
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError(
                "CUDA kernel build failed:\n" + "\n".join(failed)
            )
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(_library_path(src)))
        return _libs


class CudaKernel:
    """One hand-written kernel's C entry point. Calling it launches the
    kernel on the given arguments, raises if the launch failed, and only
    then adds one to ``launches``, the count that shows a run went
    through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self) -> None:
        """Build and bind the entry point, launching nothing (a timed
        first call then times the launch alone)."""
        if self._fn is None:
            lib = build_all()[self.source]
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.symbol}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err

    def __call__(self, *args) -> None:
        self.load()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        self.launches += 1

"""The PyTorch port imports neither JAX (nor optax or orbax) nor the JAX
package: every module of elastic_tpu_agent_torch imports in a fresh
interpreter where importing jax, optax or orbax fails, and no
elastic_tpu_agent module gets loaded."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "optax", "orbax"):
    sys.modules[blocked] = None    # any `import jax` etc. now raises
import elastic_tpu_agent_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] == "elastic_tpu_agent"
    or m.startswith("jax") and sys.modules[m] is not None
)
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, leaked = res.stdout.strip().split(" ", 1)
    assert int(count) >= 21         # workloads and every module in it
    assert leaked == "[]"

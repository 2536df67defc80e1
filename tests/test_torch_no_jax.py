"""The port imports no JAX: with jax, flax, optax and ich_tpu blocked, every
module of ich_tpu_torch and chip_smoke.py's module-level imports load."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import ich_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(ich_tpu_torch.__path__, "ich_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "ich_tpu")
              and sys.modules[m] is not None]
    assert not loaded, loaded
    print(len(names))
""")


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15  # every submodule of the slice was imported

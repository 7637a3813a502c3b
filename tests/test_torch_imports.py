"""obvi_slam_tpu_torch and every submodule import with jax, jaxlib and the
JAX package blocked (checked in a fresh interpreter: this one has imported
jax already)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "obvi_slam_tpu")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if blocked(name):
                raise ImportError(f"blocked import: {name}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import obvi_slam_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        obvi_slam_tpu_torch.__path__, "obvi_slam_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert not [m for m in sys.modules if blocked(m)]
    print(len(names))
    """
)


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module of the package

"""obvi_slam_tpu_torch and every submodule import with jax, jaxlib, the JAX
package and matplotlib blocked, and the main CLI's --help runs so (checked
in a fresh interpreter: this one has imported jax already)."""

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

    BLOCKED = ("jax", "jaxlib", "obvi_slam_tpu", "matplotlib")

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
    for name in ("obvi_slam_tpu_torch.cli", "obvi_slam_tpu_torch.io",
                 "obvi_slam_tpu_torch.metrics", "obvi_slam_tpu_torch.optlog",
                 "obvi_slam_tpu_torch.frontend.bb_retriever",
                 "obvi_slam_tpu_torch.solver.jacobian_debug",
                 "obvi_slam_tpu_torch.cli.debug_jacobian_hessian_diagonal",
                 "obvi_slam_tpu_torch.factors.epipolar",
                 "obvi_slam_tpu_torch.parallel", "obvi_slam_tpu_torch.parallel.audit",
                 "obvi_slam_tpu_torch.parallel.comm", "obvi_slam_tpu_torch.parallel.sharding",
                 "obvi_slam_tpu_torch.parallel.distributed"):
        assert name in names or name in sys.modules, name
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main
    try:
        offline_object_visual_slam_main.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
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
    assert "--params_config_file" in out.stdout
    assert int(out.stdout.split()[-1]) >= 30  # every module of the package

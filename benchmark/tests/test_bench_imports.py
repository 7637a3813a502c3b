"""What the benchmark loads: the harness, every driver and every metric
reader import with JAX and the JAX package blocked (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of JAX, the JAX package or the program."""

import ast
import subprocess
import sys
import textwrap

from benchmark import harness

BLOCKER = """
import sys
BLOCKED = set(sys.argv[1].split(","))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
"""


def _run(blocked, body):
    code = BLOCKER + textwrap.dedent(body)
    out = subprocess.run([sys.executable, "-c", code, ",".join(blocked), str(harness.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_drivers_and_readers_load_without_jax():
    out = _run(("jax", "jaxlib", "flax", "obvi_slam_tpu"), """
        from pathlib import Path
        from benchmark import harness, roofline, control, metrics_common
        from benchmark.traffic import problem, object_session, files
        for path in sorted((harness.BENCH_DIR / "drivers").glob("*.py")):
            harness.load_module(path, "driver_" + path.stem)
        for path in sorted((harness.BENCH_DIR / "metrics").glob("*.py")):
            harness.load_module(path, "metric_" + path.stem)
        # The program the drivers drive, as they import it.
        import obvi_slam_tpu_torch.cli.offline_object_visual_slam_main
        import obvi_slam_tpu_torch.solver.lm_fused
        print(sorted({m.split(".")[0] for m in sys.modules} & BLOCKED))
    """)
    assert out.strip().endswith("[]")


def test_a_cell_run_loads_no_jax():
    """A whole run on the CPU (the driver's look for a chip skipped) in a
    process that blocks JAX and the JAX package."""
    out = _run(("jax", "jaxlib", "flax", "obvi_slam_tpu"), """
        import io
        from benchmark import harness
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        wl = harness.load_json(harness.BENCH_DIR / "workloads" / "gba.band_1024.json")
        cfg = harness.load_json(harness.BENCH_DIR / "configs" / "obvi_gba_long_session.json")
        cfg.update(n_poses=24, n_points=96, n_objects=2)
        wl["reference"]["max_iterations"] = 10
        buf = io.StringIO()
        rc = harness.run(["--workload", "gba.band_1024", "--seed", "3", "--seconds", "8",
                          "--trace", "0"], device="cpu", stdout=buf,
                         files=dict(bench=bench, workload=wl, config=cfg))
        print(rc, buf.getvalue().strip().splitlines()[-1])
    """)
    assert out.strip().splitlines()[-1].startswith("0 {")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    forbidden = {"jax", "jaxlib", "flax", "obvi_slam_tpu", "obvi_slam_tpu_torch"}
    for path in sorted((harness.BENCH_DIR / "reference").glob("*.py")):
        names = {n.split(".")[0] for n in _imports(path)}
        assert not names & forbidden, (path.name, names & forbidden)
    out = _run(tuple(forbidden), """
        import benchmark.reference.build, benchmark.reference.factors
        import benchmark.reference.geometry, benchmark.reference.lm
        print(sorted({m.split(".")[0] for m in sys.modules} & BLOCKED))
    """)
    assert out.strip().endswith("[]")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "obvi_slam_tpu_torch_like", sys)
    assert "obvi_slam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "obvi_slam_tpu.solver", sys)
    assert "obvi_slam_tpu" in harness.forbidden_modules()

"""On the card only (skips without one): the control (TF32: the program on
its own TF32 path, or the reference in its place where the program takes
none; ``benchmark/control.py``) comes out not correct by the cell's own
limits on three seeds, while the program as configured comes out correct on
the same seeds.

    python -m pytest benchmark/tests/test_bench_card.py -q

The gba cells run at their own size; the objects cells at a shorter session
and window, which a test run can hold. The readings at the cells' own sizes
come from ``benchmark/control.py`` (PERF.md gives them)."""

import json

import pytest

from benchmark import control, harness

SEEDS = (7001, 7002, 7003)


def _files(cell):
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell}.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{workload['config']}.json")
    seconds = 5.0
    if workload["driver"] == "session":
        config["n_frames"] = 120
        seconds = 15.0
    return dict(workload=workload, config=config), seconds


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_control_is_not_correct(card, cell):
    files, seconds = _files(cell)
    limits = files["workload"]["limits"]
    for seed in SEEDS:
        program = control.readings(cell, seed, seconds, device=card, files=files)
        ctl = control.control_readings(cell, seed, seconds, device=card, files=files)
        print(json.dumps({"cell": cell, "seed": seed, "program": program, "control": ctl}))
        assert all(v <= limits[k] for k, v in program.items() if k in limits), (seed, program)
        assert any(v > limits[k] for k, v in ctl.items() if k in limits), (seed, ctl)

"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: configurations, workloads, drivers and per-layer readers."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_checks_fit_the_day():
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    config = harness.load_json(harness.ROOT / entry["file"])
    assert config["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert sorted(entry["reduced"]) == sorted(config["reduced"])
    for key in entry["reduced"]:
        assert key in config, key
        assert not key.endswith(("_dim", "_rank")), key
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and _line(entry["why"])
    assert entry["chips"] in (1, 4)
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{entry['name']}.json")
    assert workload["name"] == entry["name"] and workload["config"] == entry["config"]
    assert (harness.BENCH_DIR / "drivers" / f"{workload['driver']}.py").is_file()
    control = workload.get("control", "program_tf32")
    assert control in ("program_tf32", "reference_tf32")
    if control == "reference_tf32":
        driver = harness.load_module(harness.BENCH_DIR / "drivers" / f"{workload['driver']}.py",
                                     f"driver_{workload['driver']}")
        assert callable(driver.reference_control)
    e2e, layer = harness.cell_metrics(BENCH, entry["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


def test_cells_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    assert _line(metric["layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e and metric["moves"] != "setup_s"
    moved = set(e2e[metric["moves"]].get("workloads", [w["name"] for w in BENCH["workloads"]]))
    assert set(metric["workloads"]) <= moved
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{metric['name']}.py",
                                 f"metric_{metric['name']}")
    assert callable(reader.read)
    assert reader.read({"frames": 0, "trace": None}) is None


def test_layer_names_are_consistent():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_names():
    for path in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_limits_cover_the_checks(entry):
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / f"{entry['name']}.json")
    assert workload["limits"] and all(v >= 0 for v in workload["limits"].values())

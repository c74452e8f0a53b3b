"""The benchmark's files: BENCHMARK.json within its contract, and every
configuration, traffic mix, limit and per-layer metric found and parsed by
the name BENCHMARK.json gives it."""

import json
import math
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        if "why" in entry:
            assert _line(entry["why"]), entry["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and "d_model" not in key
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1


def test_metrics_and_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reports, (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        c = harness.cell(cell)
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                     if w["name"] == cell)
    assert (harness.HERE / "drivers" / f"{c.kind}.py").exists()
    assert c.limits and all(math.isfinite(v) and v >= 0 for v in c.limits.values())
    sizes = harness.counts(c.config)
    assert sizes.params() > 0
    for m in c.per_layer:
        assert callable(harness.metric(m["name"]).read)


@pytest.mark.parametrize("path", sorted((harness.HERE / "traffic").glob("*.json"))
                         + sorted((harness.HERE / "limits").glob("*.json")),
                         ids=lambda p: p.name)
def test_data_files_parse(path):
    data = json.loads(path.read_text())
    assert isinstance(data, dict)


def test_every_file_name_is_made_of_name_characters():
    for p in harness.HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel

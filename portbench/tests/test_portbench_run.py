"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: the result line's schema, its checks last, the same
numbers compared on the same seed; and the command itself refusing to run
without a card."""

import json
import math
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
ROOT = harness.ROOT


def _run(tiny_cell, name, trace, seed=2**31 + 11, seconds=None):
    # a traced window also holds the profiler's start and stop, slow on a CPU
    seconds = seconds or (6.0 if trace else 2.0)
    return harness.run_cell(tiny_cell(name), seed, seconds, trace, "cpu", log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tiny_cell, cell, trace):
    r = _run(tiny_cell, cell, trace)
    json.dumps(r)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    c = harness.cell(cell)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    for name, m in r["metrics"].items():
        assert name in want and set(m) == {"value", "unit"} and math.isfinite(m["value"])
    if not trace:
        assert sorted(r["metrics"]) == sorted(want)
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        for k in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][k]) <= 10
    for name, x in r["checks"].items():
        assert set(x) == {"value", "limit"} and x["value"] <= x["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_readings(tiny_cell, cell):
    a = _run(tiny_cell, cell, False, seed=5, seconds=1.0)
    b = _run(tiny_cell, cell, False, seed=5, seconds=1.0)
    if cell == "fl_tdm_int8":          # fixed work before the window
        assert a["checks"] == b["checks"]
    assert a["checks"].keys() == b["checks"].keys()


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_files_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert not (pathlib.Path(tmp_path) / "src").exists()

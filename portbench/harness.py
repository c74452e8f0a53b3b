"""The benchmark's machinery, driven by data.

``BENCHMARK.json`` names the cells; each cell names a configuration
(``configs/<config>.json``, with its counts in ``configs/<config>.py``) and a
traffic mix (``traffic/<traffic>.json``), whose ``kind`` names the driver
(``drivers/<kind>.py``). The per-layer metrics are readers of their own
(``metrics/<metric>.py``), and the limits of a cell's comparisons sit in
``limits/<cell>.json``. Adding a cell, a mix, a configuration or a metric is
adding files.

A driver has three functions:

- ``setup(run) -> job``: builds the system under test from the seed and warms
  every shape its window uses;
- ``window(run, job) -> dict``: drives the timed path for ``run.seconds``
  through ``run.open`` / ``run.done_unit`` and returns its end-to-end values
  and counts (``attempted``, ``failed``);
- ``check(run, job, out) -> {name: value}``: frees the program's state and
  compares what the window produced with the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """Import a file by path (configuration and metric files are named
    after their entries, which may hold dots and dashes)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _for_cell(metric: dict, cell: str, reports: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reports


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reports = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name, reports)]
    return Cell(
        name=name,
        config=load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        chips=int(entry["chips"]),
        limits=load_json(HERE / "limits" / f"{name}.json")["limits"],
        end_to_end=e2e,
        per_layer=per_layer,
    )


def counts(config: dict):
    """The configuration's counts (``configs/<name>.py``'s ``counts``)."""
    mod = load_module(HERE / "configs" / f"{config['name']}.py",
                      f"portbench_config_{config['name'].replace('-', '_')}")
    return mod.counts(config)


def program_config(config: dict):
    """The port's ModelConfig for a configuration file: the registered arch
    the file names (its smoke config where the file says ``"arch_variant":
    "smoke"``, the tests' size), cut as the file says, its sizes checked."""
    from repro_torch.configs import archs

    arch = archs.get(config["arch"])
    if config.get("arch_variant") == "smoke":
        arch = archs.smoke_cfg(arch)
    cfg = arch.replace(n_layers=int(config["n_layer"]))
    s, mb = config["ssm_cfg"], cfg.mamba
    have = {"d_model": cfg.d_model, "vocab_size": cfg.vocab_size, "d_state": mb.d_state,
            "d_conv": mb.d_conv, "expand": mb.expand, "headdim": mb.head_dim,
            "ngroups": mb.n_groups, "chunk_size": mb.chunk,
            "tie_embeddings": cfg.tie_embeddings, "norm_eps": cfg.norm_eps}
    want = {"d_model": config["d_model"], "vocab_size": config["vocab_size"],
            "tie_embeddings": config["tie_embeddings"], "norm_eps": config["norm_eps"],
            **{k: s[k] for k in ("d_state", "d_conv", "expand", "headdim", "ngroups",
                                 "chunk_size")}}
    bad = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if bad:
        raise ValueError(f"{config['arch']} in the program differs from {config['name']}: {bad}")
    prec = config["precision"]
    if (cfg.param_dtype, cfg.compute_dtype) != (prec["params"], prec["compute"]):
        raise ValueError(f"{config['arch']} runs {cfg.param_dtype}/{cfg.compute_dtype}, "
                         f"{config['name']} states {prec}")
    return cfg


class Run:
    """One run of one cell: its inputs, the window's clock, the profiled
    stretch of a traced run, and what the metric readers read."""

    def __init__(self, c: Cell, seed: int, seconds: float, trace: bool, device,
                 t0: Optional[float] = None):
        import torch

        self.cell = c
        self.config, self.traffic = c.config, c.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.sizes = counts(c.config)
        self.stats: Dict[str, Any] = {}
        self.spans: list = []
        self.devtrace = None
        self._t_open = None
        self._stretch = None
        self._stretch_done = False
        self._stretch_us = (float("inf"), float("inf"))   # the stretch, recorder clock
        self.stretch_clock = (float("inf"), float("inf"))  # the same, host clock
        self.paused_s = 0.0         # window time spent starting and stopping the profiler

    # -- inputs -----------------------------------------------------------
    def rng(self, *key: int) -> np.random.Generator:
        """A numpy generator for the seed and a key (the same pair, the same
        draws)."""
        return np.random.default_rng([self.seed % (1 << 63), *[int(k) for k in key]])

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -------------------------------------------------------
    def open_window(self) -> float:
        """Synchronise, read the clock: the window opens; set-up ends."""
        from repro_torch import telemetry

        self.sync()
        self._t_open = time.perf_counter()
        self._rec_open_us = telemetry.get_recorder().now_us()
        self.setup_s = self._t_open - self.t0
        return self._t_open

    def open(self) -> bool:
        """Is the window still open (read before starting a unit)?"""
        return time.perf_counter() - self._t_open < self.seconds

    def done_unit(self, units: int) -> None:
        """After each unit of the window: in a traced run, the profiled
        stretch covers units ``first .. first + count - 1``."""
        if not self.trace:
            return
        first, count = self.traffic["profile"]["first"], self.traffic["profile"]["units"]
        from repro_torch import telemetry

        t = time.perf_counter()
        if units == first:
            from portbench.devtrace import Stretch

            self._stretch = Stretch(self.device)
            self._stretch.start()
            self._stretch_us = (telemetry.get_recorder().now_us(), float("inf"))
            self.stretch_clock = (t, float("inf"))
        elif units == first + count and self._stretch is not None:
            self._stretch.stop()
            self._stretch_done = True
            self._stretch_us = (self._stretch_us[0], telemetry.get_recorder().now_us())
        else:
            return
        now = time.perf_counter()
        self.paused_s += now - t
        if units == first + count:
            self.stretch_clock = (self.stretch_clock[0], now)

    def close_window(self) -> float:
        """Synchronise, read the clock: the window's length in seconds."""
        from repro_torch import telemetry

        self.sync()
        seconds = time.perf_counter() - self._t_open
        if self._stretch is not None:
            if self._stretch_done:
                self.devtrace = self._stretch.read()
            else:                               # a window too short for the stretch
                self._stretch.stop()
            self._stretch = None
        rec = telemetry.get_recorder()
        self.spans = [s for s in rec.spans if s.t_start_us >= self._rec_open_us]
        return seconds

    # -- readers' helpers --------------------------------------------------
    def span_ms(self, name: str) -> List[float]:
        """Durations of the window's spans ``name``, leaving out those the
        profiled stretch overlaps (the profiler slows what it records)."""
        a, b = self._stretch_us
        return [s.dur_us / 1e3 for s in self.spans if s.name == name
                and (s.t_start_us + s.dur_us <= a or s.t_start_us >= b)]


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"portbench_metric_{name.replace('.', '_')}")


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None, log=None) -> dict:
    """Run cell ``c`` once and return the result line's object."""
    import torch

    from repro_torch import telemetry

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver = importlib.import_module(f"portbench.drivers.{c.kind}")
    run = Run(c, seed, seconds, trace, device, t0)
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    with telemetry.record_scope(tracing=run.trace):
        job = driver.setup(run)
        out = driver.window(run, job)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    t_check = time.perf_counter()
    readings = driver.check(run, job, out)
    run.stats.update(check_s=time.perf_counter() - t_check, setup_s=run.setup_s)
    del job
    free_device()

    metrics: Dict[str, dict] = {}
    if run.trace:
        for m in c.per_layer:
            value = metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=run.setup_s)
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(c.limits[k])} for k, v in readings.items()}
    correct = bool(checks) and all(
        math.isfinite(x["value"]) and x["value"] <= x["limit"] for x in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if run.trace and run.devtrace is not None:
        device_info["busy_s"] = run.devtrace.busy_s
        device_info["window_s"] = run.devtrace.window_s
        result["breakdown"] = run.devtrace.breakdown()
    log("stats " + json.dumps({k: v for k, v in run.stats.items()
                               if isinstance(v, (int, float, str))}))
    for k, x in checks.items():
        log(f"check {k}: {x['value']!r} (limit {x['limit']!r})")
    result["checks"] = checks
    return result

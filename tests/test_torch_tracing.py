"""The port's phase spans and device spans (``telemetry/devclock.py``).

With tracing off, the exchange round, local training and a serving slot
record no span, create no CUDA event and synchronise nothing. With tracing
on, each records its phases in order (``tdm.*`` in the int8 mix, the
``fl.local.*`` of each node's step, the ``serve.*`` of a slot); on the CPU
they carry no device time. The device clock's bookkeeping (one anchor, pooled
events, spans filled once their exit event has completed, never by a
synchronise of its own) runs against fake CUDA events. The Chrome export of a
recording without device spans is the reference's; device spans add a track.

The ``cuda`` test runs on the card (``python -m pytest -m cuda
tests/test_torch_tracing.py``): every device span of an int8 mix is filled
after a synchronise, and the mix's phases add up to its ``tdm.round``.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import archs
from repro_torch.core import fl, fused, tdm
from repro_torch.core.relation import Relation
from repro_torch.launch import fl_train
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.telemetry import devclock
from repro_torch.telemetry.export import DEVICE_TID

N = 8
RING = Relation.from_edges([(i, (i + 1) % N) for i in range(N)], nodes=range(N))
INT8 = fl.TDMFLAConfig(compression="int8")


def _params(device="cpu", scale=1):
    g = torch.Generator(device=device).manual_seed(0)
    shapes = {"a": (N, 3000 * scale), "b": {"c": (N, 50, 20 * scale), "d": (N, 7)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return torch.randn(s, generator=g, device=device)

    return draw(shapes)


def _int8_round(device="cpu"):
    fl.tdm_fla_round(_params(device), RING, N, INT8)


def _local_train(nodes=2, steps=2):
    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(
        compute_dtype="float32", n_layers=1)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    state = fl_train._stack_init(0, cfg, opt_cfg, nodes, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (nodes, steps, 1, 9))
    batch = fl_train.batch_to_device(
        {"tokens": toks[..., :-1].astype(np.int32), "labels": toks[..., 1:].astype(np.int32)},
        "cpu")
    fl_train.local_train(registry.bundle(cfg), opt_cfg, state, batch, steps)


def _engine():
    from repro_torch.constellation.scenario import smoke_scenario
    from repro_torch.serving import ModelDecoder, ReplicaFleet, ServingEngine
    from repro_torch.serving.requests import synthesize_workload

    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype="float32")
    scn = smoke_scenario()
    dec = ModelDecoder(cfg, 2, 2, 40, device="cpu")
    eng = ServingEngine.from_scenario(scn, ReplicaFleet([0, 3], 2, dec))
    for req in synthesize_workload(4, scn.ground_ids, rate_per_slot=4.0, max_new=4):
        eng.submit(req)
    return eng


def _serving_slots(eng, until_prefill=True, most=60):
    """Step ``eng`` until a slot admitted a wave (with ``until_prefill``)."""
    for _ in range(most):
        eng.step()
        if not until_prefill or eng.records[-1].admitted:
            return
    raise AssertionError("no wave admitted")


UNITS = {
    "int8_round": _int8_round,
    "local_train": _local_train,
    "serving_slot": lambda: _serving_slots(_engine()),
}


@pytest.fixture
def no_device_calls(monkeypatch):
    """Fail any CUDA event or synchronise the code under test asks for."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA event or synchronise with tracing off or on the CPU")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_tracing_off_records_no_span(unit, no_device_calls):
    with telemetry.record_scope(tracing=False) as rec:
        UNITS[unit]()
    assert rec.spans == [] and rec._devclock is None


def _names(rec):
    return [s.name for s in rec.spans]


def test_int8_round_records_its_phases_in_order(no_device_calls):
    m = len(tdm.edge_coloring(RING))
    assert m >= 2
    with telemetry.record_scope(tracing=True) as rec:
        _int8_round()
    assert _names(rec) == (["tdm.flatten", "tdm.quantize"] + ["tdm.gather"] * m
                           + ["tdm.fold", "tdm.self", "tdm.unflatten", "tdm.round"])
    assert all(s.dev is None and s.dev_us is None and s.dev_t_us is None for s in rec.spans)
    # link bytes, counted from the matchings the mix coloured
    padded = fused.cached_spec(_params()).padded_size("float32")
    assert rec.get_counter("fused.exchange.wire_bytes_per_round") == m * fused.mix_wire_bytes(
        padded, 4, "int8")
    assert "fused.exchange.mixes_traced" not in rec.counters
    assert "fused.exchange.wire_mbytes" not in rec.hists


def test_two_level_int8_records_each_levels_mix(no_device_calls):
    intra = Relation.from_edges([(0, 1), (2, 3)], nodes=range(4))
    inter = Relation.from_edges([(0, 1)], nodes=range(2))
    with telemetry.record_scope(tracing=True) as rec:
        fused.fused_hierarchical_round(_params(), intra, inter, 4, 2, compression="int8")
    one_level = ["tdm.quantize", "tdm.gather", "tdm.fold", "tdm.self"]
    assert _names(rec) == one_level * 2


def test_local_train_records_each_node_steps_phases(no_device_calls):
    with telemetry.record_scope(tracing=True) as rec:
        _local_train(nodes=2, steps=3)
    assert _names(rec) == ["fl.local.forward", "fl.local.backward", "fl.local.optimizer"] * 6
    assert all(s.dev_us is None for s in rec.spans)


def test_serving_slot_records_its_phases(no_device_calls):
    eng = _engine()
    with telemetry.record_scope(tracing=True) as rec:
        _serving_slots(eng)                   # the slot that admits also decodes
    names = _names(rec)
    assert names[:-13] == ["serve.route", "serve.admit", "serve.tick", "serve.slot"] * (
        len(eng.records) - 1)
    assert names[-13:] == [
        "serve.route",
        "serve.model", "serve.write", "serve.tokens", "serve.prefill", "serve.admit",
        "serve.fold", "serve.model", "serve.write", "serve.tokens", "serve.decode",
        "serve.tick", "serve.slot"]
    assert all(s.dev_us is None for s in rec.spans)


def test_export_without_device_spans_is_the_references():
    from repro.telemetry import export as j_export

    with telemetry.record_scope(tracing=True) as rec:
        rec.counter("fl.rounds", 2)
        with rec.span("fl.round", cat="round", round=0):
            _int8_round()
        rec.event("fl.node_lost", node=3)
    assert telemetry.chrome_trace(rec) == j_export.chrome_trace(rec)


def test_export_puts_device_spans_on_a_device_track():
    with telemetry.record_scope(tracing=True) as rec:
        with rec.span("host", cat="c"):
            pass
    host = telemetry.chrome_trace(rec)
    rec._spans.append(telemetry.Span("tdm.round", "exchange", 10.0, 5.0, {"k": 1}, 0,
                                     dev=0, dev_t_us=12.0, dev_us=7.5))
    rec._spans.append(telemetry.Span("tdm.self", "exchange", 20.0, 1.0, {}, 0, dev=0))
    tr = telemetry.chrome_trace(rec)["traceEvents"]
    dev = [e for e in tr if e.get("tid") == DEVICE_TID]
    assert [(e["ph"], e["name"]) for e in dev] == [("M", "thread_name"), ("X", "tdm.round")]
    assert dev[0]["args"] == {"name": "cuda:0 stream"}
    assert (dev[1]["ts"], dev[1]["dur"], dev[1]["args"]) == (12.0, 7.5, {"k": 1})
    # the host events are those of a host-only recording plus the two spans
    assert [e for e in host["traceEvents"] if e["ph"] == "X"] == [
        e for e in tr if e["ph"] == "X" and e["tid"] == 0 and e["name"] == "host"]


class _FakeCuda:
    """Fake CUDA events on one fake stream: ``record`` stamps the device
    time ``now`` (ms); an event has completed once ``done`` passed it."""

    def __init__(self, monkeypatch):
        self.now, self.done, self.made, self.syncs = 0.0, -1.0, 0, 0
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                fake.made += 1
                self.t = None

            def record(self, stream):
                self.t = fake.now

            def query(self):
                return self.t is not None and self.t <= fake.done

            def elapsed_time(self, end):
                assert self.query() and end.query()
                return end.t - self.t

        def synchronize(idx=None):
            fake.syncs += 1
            fake.done = fake.now

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda idx=None: "stream")
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def test_device_clock_fills_spans_without_synchronising(monkeypatch):
    cuda = _FakeCuda(monkeypatch)
    gpu = torch.device("cuda")
    with telemetry.record_scope(tracing=True) as rec:
        cuda.now = 5.0                              # the anchor, after its synchronise
        with rec.span("a", device=gpu, k=1) as args:
            assert args == {"k": 1}
            cuda.now = 8.0
        assert cuda.syncs == 1 and cuda.made == 3   # the anchor and the span's two
        assert len(rec._devclock._pending) == 1 and rec._spans[0].dev_us is None
        cuda.done = 8.0
        a = rec.spans[0]                            # reading fills what completed
        anchor_us = rec._devclock._anchor[0][1]
        assert (a.dev, a.dev_us, a.dev_t_us, a.args) == (0, 3000.0, anchor_us, {"k": 1})
        cuda.now = 10.0
        with rec.span("b", device=gpu):             # a's events, pooled
            cuda.now = 14.0
        with rec.span("c", device=gpu):             # the device falls behind
            cuda.now = 15.0
        with rec.span("host"):
            pass
        assert cuda.made == 5 and len(rec._devclock._pending) == 2
        cuda.done = 14.0                            # b completed, not c
        assert [s.dev_us for s in rec.spans] == [3000.0, 4000.0, None, None]
        cuda.done = 15.0
        spans = rec.spans                           # read after a reader's synchronise
    assert [s.dev_us for s in spans] == [3000.0, 4000.0, 1000.0, None]
    assert [s.dev_t_us - anchor_us for s in spans[:3]] == [0.0, 5000.0, 9000.0]
    assert spans[3].dev is None and cuda.syncs == 1
    assert len(rec._devclock._pending) == 0


def test_device_clock_checks_past_its_bound(monkeypatch):
    cuda = _FakeCuda(monkeypatch)
    monkeypatch.setattr(devclock, "MAX_PENDING", 3)
    with telemetry.record_scope(tracing=True) as rec:
        for _ in range(3):
            with rec.span("s", device=torch.device("cuda", 0)):
                cuda.now += 1.0
                cuda.done = cuda.now                # each completes at once
            if len(rec._spans) < 3:                 # below the bound, nothing checked
                assert rec._spans[-1].dev_us is None
        assert len(rec._devclock._pending) == 0     # the third reached it: all filled
        assert [s.dev_us for s in rec._spans] == [1000.0] * 3


def test_device_clock_records_nothing_in_a_graph_capture(monkeypatch):
    cuda = _FakeCuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with telemetry.record_scope(tracing=True) as rec:
        with rec.span("a", device=torch.device("cuda", 0)):
            pass
    assert cuda.made == 0 and cuda.syncs == 0 and rec.spans[0].dev is None


def test_recorder_imports_no_torch():
    """Device spans import torch only when a traced span names a CUDA device."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.telemetry.recorder as r\n"
            "with r.record_scope(tracing=True) as rec:\n"
            "    with rec.span('a', device=None):\n"
            "        pass\n"
            "print(sorted({'torch', 'repro_torch.telemetry.devclock'} & set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans record CUDA events)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_int8_mix_phases_add_up_on_the_card(device):
    params = _params(device, scale=16384)         # 2.1 GB: a mix of ~10 ms
    fl.tdm_fla_round(params, RING, N, INT8)        # builds and warms the kernels
    torch.cuda.synchronize(device)
    with telemetry.record_scope(tracing=True) as rec:
        for _ in range(3):
            fl.tdm_fla_round(params, RING, N, INT8)
        torch.cuda.synchronize(device)
        spans = rec.spans
    assert spans and all(s.dev == 0 and s.dev_us is not None and s.dev_t_us is not None
                         for s in spans)
    rounds = [i for i, s in enumerate(spans) if s.name == "tdm.round"]
    assert len(rounds) == 3
    start = 0
    for i in rounds:
        whole, phases = spans[i], spans[start:i]
        assert whole.dev_us > 0
        assert abs(sum(s.dev_us for s in phases) - whole.dev_us) <= 0.05 * whole.dev_us
        for s in phases:                       # each phase inside its round, on the stream
            assert whole.dev_t_us - 5 <= s.dev_t_us
            assert s.dev_t_us + s.dev_us <= whole.dev_t_us + whole.dev_us + 5
        start = i + 1
    tr = telemetry.chrome_trace(rec)["traceEvents"]
    assert sum(e["ph"] == "X" and e["tid"] == DEVICE_TID for e in tr) == len(spans)

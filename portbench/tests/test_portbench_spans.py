"""The phase readers (``spans.py`` and the metrics that use it) against a
hand-built run: units inside and outside the profiled stretch, phases
summed inside each unit, a phase of another unit left out, and nothing read
from a program whose spans carry no device time or that lacks the spans."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans

STRETCH = (1000.0, 2000.0)          # the profiled stretch, recorder clock (us)


def span(name, t, dur, dev_us=None, **kw):
    return SimpleNamespace(name=name, t_start_us=float(t), dur_us=float(dur),
                           dev_us=dev_us, **kw)


def run_of(tiny_cell, cell, spans_):
    run = harness.Run(tiny_cell(cell), seed=3, seconds=1.0, trace=True, device="cpu")
    run.spans = spans_
    run._stretch_us = STRETCH
    return run


def unit(name, t, dur, phases):
    """A unit span at ``t`` and its phases, laid end to end from ``t + 1``:
    (name, device us) pairs."""
    out, at = [span(name, t, dur)], t + 1
    for p, us in phases:
        out.append(span(p, at, 2, dev_us=us))
        at += 3
    return out


TDM = [("tdm.flatten", 500.0), ("tdm.quantize", 300.0), ("tdm.gather", 100.0),
       ("tdm.fold", 200.0), ("tdm.gather", 110.0), ("tdm.fold", 210.0),
       ("tdm.self", 900.0), ("tdm.unflatten", 10.0)]


def tdm_run(tiny_cell, scale=(1.0, 3.0)):
    a, b = scale
    s = (unit("tdm.round", 0, 100, TDM)
         + unit("tdm.round", 990, 100, [(n, 1e6) for n, _ in TDM])   # overlaps the stretch
         + unit("tdm.round", 1500, 100, [(n, 1e6) for n, _ in TDM])  # inside it
         + unit("tdm.round", 3000, 100, [(n, us * b) for n, us in TDM]))
    return run_of(tiny_cell, "tdm_slots_int8", s)


@pytest.mark.parametrize("metric,want", [
    ("tdm_flatten_ms", 0.510), ("tdm_gather_ms", 0.210),
    ("tdm_codec_ms", 0.710), ("tdm_self_ms", 0.900)])
def test_tdm_phases_per_slot(tiny_cell, metric, want):
    got = harness.metric(metric).read(tdm_run(tiny_cell))
    assert got == pytest.approx(want * (1 + 3) / 2)


@pytest.mark.parametrize("metric", ["tdm_flatten_ms", "tdm_gather_ms", "tdm_codec_ms",
                                    "tdm_self_ms", "fl_forward_ms", "fl_backward_ms",
                                    "fl_optimizer_ms", "serve_fold_ms"])
@pytest.mark.parametrize("program", ["cpu", "parent", "absent"])
def test_nothing_to_read(tiny_cell, metric, program):
    """Spans without device time (the CPU), spans of a program without the
    field, or a program without the spans: the reader returns None."""
    s = tdm_run(tiny_cell).spans + fl_spans() + serve_spans()
    if program == "cpu":
        s = [span(x.name, x.t_start_us, x.dur_us) for x in s]
    elif program == "parent":
        s = [SimpleNamespace(name=x.name, t_start_us=x.t_start_us, dur_us=x.dur_us) for x in s]
    else:
        s = [x for x in s if x.name in ("tdm.round", "fl.local_steps", "serve.decode")]
    assert harness.metric(metric).read(run_of(tiny_cell, "tdm_slots_int8", s)) is None


def fl_spans():
    step = [("fl.local.forward", 1000.0), ("fl.local.backward", 2000.0),
            ("fl.local.optimizer", 500.0)]
    return (unit("fl.local_steps", 100, 900, step * 4)
            + unit("fl.local_steps", 1200, 900, step * 4)      # inside the stretch
            + unit("fl.local_steps", 5000, 900, [(n, us * 2) for n, us in step] * 4))


@pytest.mark.parametrize("metric,per_step", [
    ("fl_forward_ms", 1.0), ("fl_backward_ms", 2.0), ("fl_optimizer_ms", 0.5)])
def test_fl_phases_per_round(tiny_cell, metric, per_step):
    got = harness.metric(metric).read(run_of(tiny_cell, "fl_tdm_int8", fl_spans()))
    assert got == pytest.approx(per_step * 4 * (1 + 2) / 2)


def serve_spans():
    """Two slots outside the stretch: one admits (a prefill with its own
    ``serve.write``) and decodes, one only decodes; one slot inside it."""
    s = [span("serve.slot", 0, 100), span("serve.route", 1, 5),
         span("serve.admit", 7, 40), span("serve.prefill", 8, 30),
         span("serve.write", 9, 5, dev_us=7000.0),
         span("serve.tick", 50, 40), span("serve.decode", 51, 30)]
    s += [span("serve.fold", 52, 3, dev_us=1500.0), span("serve.write", 60, 3, dev_us=500.0)]
    s += [span("serve.slot", 1100, 100), span("serve.decode", 1110, 50),
          span("serve.fold", 1111, 2, dev_us=1e6)]
    s += [span("serve.slot", 3000, 60), span("serve.decode", 3010, 20),
          span("serve.fold", 3011, 2, dev_us=1000.0), span("serve.write", 3014, 2, dev_us=1000.0)]
    return s


def test_serve_fold_per_tick(tiny_cell):
    got = harness.metric("serve_fold_ms").read(run_of(tiny_cell, "serve_short_chat",
                                                      serve_spans()))
    assert got == pytest.approx((2.0 + 2.0) / 2)      # the prefill's write left out


def test_serve_engine_per_slot(tiny_cell):
    got = harness.metric("serve_engine_ms").read(run_of(tiny_cell, "serve_short_chat",
                                                        serve_spans()))
    assert got == pytest.approx(((100 - 30 - 30) + (60 - 20)) / 2 / 1e3)
    assert harness.metric("serve_engine_ms").read(run_of(tiny_cell, "serve_short_chat", [])) \
        is None


def test_units_leave_out_spans_across_the_stretch(tiny_cell):
    run = tdm_run(tiny_cell)
    got = [(u.t_start_us, len(inner)) for u, inner in spans.units(run, "tdm.round")]
    assert got == [(0.0, len(TDM)), (3000.0, len(TDM))]

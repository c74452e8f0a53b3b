"""Readers' helpers for the program's phase spans.

A unit of work (a slot's mix, a round's local training, a decode tick, an
engine slot) is one span of the program; its phases are the spans inside it.
A phase metric is the mean, over the window's units, of the phases' time
summed inside each unit. Units the profiled stretch overlaps are left out,
as ``Run.span_ms`` leaves them out (the profiler slows what it records).

``dev_ms`` reads a device span's stream time (``dev_us``: the CUDA events the
recorder put at the span's edges); ``host_ms`` a span's host time. Where the
program has no such span, or its spans carry no device time (a CPU run, or
a program without device spans), the readers find nothing and return None.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, Iterator, List, Optional, Sequence, Tuple


def outside(run, s) -> bool:
    """Does span ``s`` lie clear of the profiled stretch?"""
    a, b = run._stretch_us
    return s.t_start_us + s.dur_us <= a or s.t_start_us >= b


def dev_ms(s) -> Optional[float]:
    us = getattr(s, "dev_us", None)
    return None if us is None else us / 1e3


def host_ms(s) -> float:
    return s.dur_us / 1e3


def units(run, unit: str) -> Iterator[Tuple[object, List[object]]]:
    """(unit span, the spans inside it) for each of the window's spans
    ``unit`` outside the profiled stretch, in order."""
    spans = sorted(run.spans, key=lambda s: s.t_start_us)
    starts = [s.t_start_us for s in spans]
    for u in spans:
        if u.name != unit or not outside(run, u):
            continue
        end = u.t_start_us + u.dur_us
        lo = bisect.bisect_left(starts, u.t_start_us)
        hi = bisect.bisect_right(starts, end)
        yield u, [s for s in spans[lo:hi] if s is not u and s.t_start_us + s.dur_us <= end]


def phase_ms(run, unit: str, phases: Sequence[str],
             time: Callable[[object], Optional[float]] = dev_ms) -> Optional[float]:
    """The mean over the window's ``unit`` spans of the summed ``time`` of
    the ``phases`` spans inside each. A unit holding none of them, or one
    without a reading, is left out; None where no unit is left."""
    per = []
    for _, inner in units(run, unit):
        got = [time(s) for s in inner if s.name in phases]
        if got and None not in got:
            per.append(sum(got))
    return statistics.fmean(per) if per else None

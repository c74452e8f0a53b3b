"""A short profiled stretch of a run: ``torch.profiler`` over a few units of
work, reduced to the device's busy time (the union of its activities), the
stretch's length, device time by operation name and the idle gaps by what the
host was doing.

Every time here is the profiler's own clock; the stretch is bounded by a
``portbench.stretch`` annotation on the host, opened after a synchronise
and closed after another.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "portbench.stretch"
NAME_CHARS = 160
# the profiler's own bookkeeping on the host, which names no work of the run
PROFILER_OWN = frozenset({"Activity Buffer Request"})


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]          # name -> (seconds, launches)
    gaps: Dict[str, float]                     # host activity -> idle seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel(self, pattern: str) -> Optional[Tuple[float, int]]:
        """(seconds, launches) of the device operations whose name matches
        ``pattern`` (a regular expression, searched), or None if none ran."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.ops.items() if rx.search(k)]
        if not hits:
            return None
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:NAME_CHARS], v[0]] for k, v in ops],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps]}


class Stretch:
    """Start and stop a profiled stretch around some units of work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._ann = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._ann = record_function(STRETCH)
        self._ann.__enter__()

    def stop(self) -> None:
        self._sync()
        self._ann.__exit__(None, None, None)
        self._prof.stop()

    def read(self) -> DeviceTrace:
        """The stopped stretch, reduced (outside the window: it takes
        seconds for ~10^5 launches)."""
        trace = reduce(self._prof)
        self._prof = None
        return trace


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof) -> DeviceTrace:
    """The stretch's busy and idle time from the profiler's raw events (a
    FunctionEvent tree of ~10^5 launches takes minutes to build)."""
    from torch.autograd import DeviceType

    dev: List[Tuple[int, int]] = []
    ops: Dict[str, List[float]] = {}
    host: List[Tuple[int, int, str]] = []
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.name() == STRETCH:
            if e.device_type() != DeviceType.CUDA:      # its device copy is no work
                w0, w1 = s, s + d
            continue
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, s + d))
            acc = ops.setdefault(e.name(), [0.0, 0])
            acc[0] += d / 1e9
            acc[1] += 1
        elif e.name() not in PROFILER_OWN:
            host.append((s, s + d, e.name()))
    if w0 is None:
        raise RuntimeError("the profiled stretch left no annotation")
    busy = _merge([(max(s, w0), min(e, w1)) for s, e in dev if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps, each named by the innermost host activity at its middle
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "host between operations"
        k = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, k - 512):k]):
            if h[1] >= mid:
                name = h[2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    return DeviceTrace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                       ops={k: (v[0], int(v[1])) for k, v in ops.items()}, gaps=gaps)

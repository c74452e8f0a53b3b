"""Device spans: the stream's side of a recorder span, by CUDA events.

A span that names a CUDA device while tracing is on
(``rec.span(name, device=x.device)``) records one event at entry and one at
exit on the device's current stream. Once the exit event has completed, the
span is filled in: ``dev_us`` is the stream time between the two events, and
``dev_t_us`` the start of that interval on the recorder's clock. Consecutive
device spans on one stream tile it, so their ``dev_us`` add up to the time
the stream took for the work between them: the work's device time where the
device is the bottleneck, mostly the wait for the host where the host is.

The clock of each device is anchored once per recording: a synchronise, then
one event whose host time is read beside it, at the device's first span.
After that nothing here synchronises. A span is filled in when its exit
event has completed (``query()``). That is checked when the recording's
spans are read, so after a reader's own synchronise every span is filled,
and while running once ``MAX_PENDING`` spans wait, which keeps the pending
list bounded. Checking and filling in is host work: done as each span
closes, it would land right after the program's synchronises, where the
device waits for the host. Events are pooled per device and reused once
their span is filled; a stream being captured into a CUDA graph records
none.

This module imports torch; :mod:`repro_torch.telemetry.recorder` imports it
only when a span first names a CUDA device.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

# spans waiting for their exit event before :meth:`DeviceClock.exit` checks
# which have completed: the bound on the pending list, set high so that a
# run of minutes checks rarely (16384 events are a few MB)
MAX_PENDING = 8192


class DeviceClock:
    """One recording's CUDA events: per-device anchors, a pool of events
    and the spans whose exit event has not completed yet."""

    def __init__(self, now_us: Callable[[], float]):
        self._now_us = now_us
        self._anchor: Dict[int, Tuple[torch.cuda.Event, float]] = {}
        self._free: Dict[int, List[torch.cuda.Event]] = {}
        self._pending: Deque[Tuple[Any, int, torch.cuda.Event, torch.cuda.Event]] = (
            collections.deque()
        )

    def _event(self, idx: int) -> torch.cuda.Event:
        free = self._free.setdefault(idx, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def enter(self, device: torch.device) -> Optional[tuple]:
        """Record a span's entry event on ``device``'s current stream; the
        token for :meth:`exit`, or None where no event may be recorded."""
        if torch.cuda.is_current_stream_capturing():
            return None
        idx = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(idx)
        if idx not in self._anchor:
            torch.cuda.synchronize(idx)
            anchor = torch.cuda.Event(enable_timing=True)
            t0 = self._now_us()
            anchor.record(stream)
            self._anchor[idx] = (anchor, (t0 + self._now_us()) / 2)
        ev0 = self._event(idx)
        ev0.record(stream)
        return idx, stream, ev0

    def exit(self, span, token: tuple) -> None:
        """Record the exit event of ``span`` (entered with ``token``) on the
        same stream; past ``MAX_PENDING`` waiting spans, fill in those whose
        events have completed."""
        idx, stream, ev0 = token
        ev1 = self._event(idx)
        ev1.record(stream)
        self._pending.append((span, idx, ev0, ev1))
        if len(self._pending) >= MAX_PENDING:
            self.poll()

    def poll(self) -> None:
        """Fill in the spans, oldest first, whose exit event has completed."""
        while self._pending and self._pending[0][3].query():
            span, idx, ev0, ev1 = self._pending.popleft()
            anchor, t_anchor = self._anchor[idx]
            span.dev_us = ev0.elapsed_time(ev1) * 1e3
            span.dev_t_us = t_anchor + anchor.elapsed_time(ev0) * 1e3
            self._free[idx] += (ev0, ev1)

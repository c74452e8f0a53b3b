"""Flight-recorder telemetry: low-overhead spans, counters, and events.

The runtime-observability substrate for the whole stack: the FL
drivers (:mod:`repro_torch.launch.fl_train`), the ground-segment router/engine
(:mod:`repro_torch.groundseg`), the schedule optimizer
(:mod:`repro_torch.constellation.optimizer`) and the fused exchange engine's
caches (:mod:`repro_torch.core.fused`) all record here, and
:mod:`repro_torch.telemetry.export` turns a recording into a Chrome-trace
(Perfetto-loadable) file plus a JSON metrics snapshot.

Contract (verified by ``tests/_telemetry_worker.py`` on 8 devices):

- **Counters are default-on and free of device traffic.** A counter bump
  is one Python dict update on the host; it never touches device values,
  never forces a transfer, and never changes what gets compiled — with
  telemetry disabled the compiled programs and their outputs are
  bit-identical to an uninstrumented build, and the driver loops issue
  ZERO additional host syncs.
- **Spans and events exist only while tracing is on.** Accurate per-round
  wall time needs a ``block_until_ready`` host sync, and per-payload
  lifecycle events are unbounded over a long run — both are opt-in via
  :func:`set_tracing` / ``record_scope(tracing=True)``. With tracing off,
  :meth:`Recorder.span` is a no-op context manager that records nothing
  and takes no timestamps.
- **Recordings are scoped, not global.** :func:`record_scope` pushes a
  fresh :class:`Recorder` for one benchmark/test/training run and pops it
  after, so counters cannot leak across runs (the bug the old bare
  ``fused._SPEC_CACHE_STATS`` module dict had).

The module is stdlib-only by design: :mod:`repro_torch.core` imports it, so it
must sit below everything jax-flavored in the dependency order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Buffers are bounded so a default-on recorder in a long-running service
# cannot grow without limit; drops are themselves counted. Mirrors the
# ``dropped_log_max`` idiom from ``MultiWindowRouter``: the MOST RECENT
# entries are retained (drop-oldest), because in a long tracing run the
# tail — the windows around whatever went wrong — is the part you want.
MAX_SPANS = 100_000
MAX_EVENTS = 100_000


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed interval (Chrome-trace ``"X"`` complete event)."""

    name: str
    cat: str
    t_start_us: float
    dur_us: float
    args: Dict[str, Any]
    tid: int = 0


@dataclasses.dataclass(frozen=True)
class Event:
    """One instant marker (Chrome-trace ``"i"`` instant event)."""

    name: str
    cat: str
    t_us: float
    args: Dict[str, Any]
    tid: int = 0


class Recorder:
    """A single flight recording: counters (always), spans/events (tracing).

    ``tracing``   — record spans/events and permit host-sync timing in the
                    instrumented drivers.
    ``reconcile`` — production-assert mode of the reference's drivers
                    (HLO checks of compiled rounds). The port's FL driver
                    checks every round's exchange count against the static
                    oracle whatever this flag says.
    """

    def __init__(
        self,
        tracing: bool = False,
        reconcile: bool = False,
        max_spans: Optional[int] = None,
        max_events: Optional[int] = None,
    ):
        self.tracing = bool(tracing)
        self.reconcile = bool(reconcile)
        self.counters: Dict[str, float] = {}
        # gauges (last-value-wins) and fixed-bucket histograms — written
        # through repro_torch.telemetry.metrics, same default-on host-side
        # discipline as counters (hists values are metrics.Histogram;
        # typed Any here so this module stays import-root).
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Any] = {}
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.meta: Dict[str, Any] = {}
        self.max_spans = MAX_SPANS if max_spans is None else int(max_spans)
        self.max_events = MAX_EVENTS if max_events is None else int(max_events)
        self._t0_ns = time.perf_counter_ns()

    # -- clock ------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since this recorder was created (monotonic)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    # -- counters (default-on) --------------------------------------------
    def counter(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def set_counter(self, name: str, value: float) -> None:
        self.counters[name] = value

    def get_counter(self, name: str, default: float = 0) -> float:
        return self.counters.get(name, default)

    def pop_counters(self, prefix: str) -> Dict[str, float]:
        """Remove and return every counter under ``prefix`` (scope reset
        for one subsystem, e.g. ``fused.clear_spec_cache``)."""
        hit = [k for k in self.counters if k.startswith(prefix)]
        return {k: self.counters.pop(k) for k in hit}

    # -- events / spans (tracing only) ------------------------------------
    def event(self, name: str, cat: str = "event", tid: int = 0, **args) -> None:
        if not self.tracing:
            return
        self.events.append(Event(name, cat, self.now_us(), args, tid))
        if len(self.events) > self.max_events:
            drop = len(self.events) - self.max_events
            del self.events[:drop]
            self.counter("telemetry.dropped_events", drop)

    @contextlib.contextmanager
    def span(
        self, name: str, cat: str = "span", tid: int = 0, **args
    ) -> Iterator[Optional[Dict[str, Any]]]:
        """Time a block. Yields the (mutable) args dict so the body can
        attach results; yields ``None`` and records nothing when tracing
        is off."""
        if not self.tracing:
            yield None
            return
        t0 = self.now_us()
        try:
            yield args
        finally:
            self.spans.append(
                Span(name, cat, t0, self.now_us() - t0, dict(args), tid)
            )
            if len(self.spans) > self.max_spans:
                drop = len(self.spans) - self.max_spans
                del self.spans[:drop]
                self.counter("telemetry.dropped_spans", drop)

    # -- introspection ----------------------------------------------------
    def span_stats(self) -> Dict[str, Dict[str, float]]:
        """Aggregate spans by name: count / total / mean / max duration (ms)."""
        agg: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            a = agg.setdefault(
                s.name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            )
            a["count"] += 1
            a["total_ms"] += s.dur_us / 1e3
            a["max_ms"] = max(a["max_ms"], s.dur_us / 1e3)
        for a in agg.values():
            a["mean_ms"] = a["total_ms"] / max(a["count"], 1)
        return agg

    def clear(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()
        self.spans.clear()
        self.events.clear()
        self.meta.clear()
        self._t0_ns = time.perf_counter_ns()


# ---------------------------------------------------------------------------
# The active recorder: a stack, so run scopes nest
# ---------------------------------------------------------------------------

_STACK: List[Recorder] = [Recorder()]


def get_recorder() -> Recorder:
    """The currently active recorder (innermost :func:`record_scope`, or
    the process-default one)."""
    return _STACK[-1]


def set_tracing(on: bool) -> None:
    """Enable/disable span+event recording on the ACTIVE recorder."""
    get_recorder().tracing = bool(on)


def set_reconcile(on: bool) -> None:
    """Enable/disable oracle reconciliation mode on the ACTIVE recorder."""
    get_recorder().reconcile = bool(on)


def tracing_enabled() -> bool:
    return get_recorder().tracing


@contextlib.contextmanager
def record_scope(
    tracing: Optional[bool] = None, reconcile: Optional[bool] = None
) -> Iterator[Recorder]:
    """Run one benchmark/test/training run against a FRESH recorder.

    Counters, spans, and events recorded inside the scope are isolated
    from (and invisible to) the enclosing scope; ``tracing``/``reconcile``
    default to the enclosing recorder's settings."""
    outer = get_recorder()
    rec = Recorder(
        tracing=outer.tracing if tracing is None else tracing,
        reconcile=outer.reconcile if reconcile is None else reconcile,
    )
    _STACK.append(rec)
    try:
        yield rec
    finally:
        _STACK.pop()


def counters_snapshot(prefix: str = "") -> Dict[str, float]:
    """Copy of the active recorder's counters (optionally filtered)."""
    return {
        k: v
        for k, v in get_recorder().counters.items()
        if k.startswith(prefix)
    }


__all__: Tuple[str, ...] = (
    "Event",
    "Recorder",
    "Span",
    "counters_snapshot",
    "get_recorder",
    "record_scope",
    "set_reconcile",
    "set_tracing",
    "tracing_enabled",
)

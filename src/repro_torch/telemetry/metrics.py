"""Metrics registry: gauges and fixed-bucket histograms on the recorder.

Extends the counters-only :class:`~repro_torch.telemetry.recorder.Recorder` with
the other two metric kinds a mission-control view needs:

- **Gauges** — last-value-wins samples (`optimizer.warm_start.hit_rate`,
  `groundseg.router.table_cache.hit_rate`): one dict write on the host,
  same default-on zero-device-sync discipline as counters.
- **Histograms** — fixed-bucket distributions (`groundseg.router.
  queue_depth`, `contact.link_utilization`, `groundseg.router.
  payload_age`): an :meth:`Histogram.observe` is one ``bisect`` plus two
  dict-free list/scalar updates; bucket layouts are fixed at first
  observation so recording never allocates per sample.

Percentile summaries surface in
:func:`repro_torch.telemetry.export.metrics_snapshot` and the Prometheus-style
text exposition in :func:`repro_torch.telemetry.export.prometheus_text`; the
mission-report generator (:mod:`repro_torch.telemetry.report`) renders both.

Like :mod:`repro_torch.telemetry.recorder`, this module is stdlib-only by
design: :mod:`repro_torch.core` and the constellation scheduler instrument
through it, so it must sit below everything jax-flavored.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.telemetry.recorder import Recorder, get_recorder

# Bucket presets (upper bounds, ascending; +Inf overflow is implicit).
# Small-integer counts: queue depths, hop counts, batch multiplicities.
COUNT_BUCKETS: Tuple[float, ...] = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
# Window-age style small integers where 0/1/2/3 each matter.
AGE_BUCKETS: Tuple[float, ...] = (0, 1, 2, 3, 4, 6, 8, 12, 16)
# Fractions in [0, 1]: link utilization, cache hit rates sampled over time.
UNIT_BUCKETS: Tuple[float, ...] = tuple(x / 10 for x in range(1, 11))
# Log-spaced positive magnitudes: seconds, megabytes — anything spanning
# orders of magnitude.
LOG_BUCKETS: Tuple[float, ...] = tuple(
    10.0**e for e in range(-4, 7)
)
DEFAULT_BUCKETS = LOG_BUCKETS


class Histogram:
    """A fixed-bucket histogram: counts per bucket plus exact sum/min/max.

    ``bounds`` are inclusive upper bounds sorted ascending; values above
    the last bound land in the implicit overflow bucket. Quantiles are
    estimated by linear interpolation inside the containing bucket and
    clamped to the exact observed ``[min, max]``, so single-valued
    histograms report exact percentiles.
    """

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Iterable[float] = DEFAULT_BUCKETS):
        bs = tuple(float(b) for b in bounds)
        if not bs or any(a >= b for a, b in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram bounds must be non-empty and ascending, got {bs}"
            )
        self.bounds = bs
        self.counts = [0] * (len(bs) + 1)  # last = overflow (> bounds[-1])
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def cumulative(self) -> List[int]:
        """Prometheus-style cumulative bucket counts (last == count)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); NaN on an empty histogram."""
        if self.count == 0:
            return math.nan
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                # linear interpolation across the containing bucket; the
                # overflow bucket has no upper bound, so report the max
                if i >= len(self.bounds):
                    return self.vmax
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i > 0 else min(self.vmin, hi)
                frac = (rank - acc) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.vmin), self.vmax)
            acc += c
        return self.vmax

    def summary(self) -> Dict[str, float]:
        """JSON-able digest: count/sum/mean/min/max plus p50/p90/p99."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


# ---------------------------------------------------------------------------
# Registry operations on the active recorder
# ---------------------------------------------------------------------------

def observe(
    name: str,
    value: float,
    buckets: Optional[Sequence[float]] = None,
    rec: Optional[Recorder] = None,
) -> None:
    """Record one histogram sample on the active recorder (default-on).

    The first observation of ``name`` fixes its bucket layout (``buckets``
    or :data:`DEFAULT_BUCKETS`); later calls reuse it, so hot loops pay
    one bisect per sample and zero allocation."""
    rec = rec or get_recorder()
    h = rec.hists.get(name)
    if h is None:
        h = rec.hists[name] = Histogram(
            DEFAULT_BUCKETS if buckets is None else buckets
        )
    h.observe(value)


def set_gauge(
    name: str, value: float, rec: Optional[Recorder] = None
) -> None:
    """Set a last-value-wins gauge on the active recorder (default-on)."""
    (rec or get_recorder()).gauges[name] = float(value)


def get_gauge(
    name: str, default: float = math.nan, rec: Optional[Recorder] = None
) -> float:
    return (rec or get_recorder()).gauges.get(name, default)


def get_histogram(
    name: str, rec: Optional[Recorder] = None
) -> Optional[Histogram]:
    return (rec or get_recorder()).hists.get(name)


def ratio_gauge(
    name: str,
    numerator: float,
    denominator: float,
    rec: Optional[Recorder] = None,
) -> None:
    """Set ``name`` to ``numerator / denominator`` (skip on zero denom) —
    the hit-rate idiom: callers pass two counter values and the gauge
    always reflects the latest totals."""
    if denominator > 0:
        set_gauge(name, numerator / denominator, rec=rec)


def histograms_summary(
    rec: Optional[Recorder] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-histogram percentile digests, sorted by name (for snapshots)."""
    rec = rec or get_recorder()
    return {name: rec.hists[name].summary() for name in sorted(rec.hists)}


__all__ = (
    "AGE_BUCKETS",
    "COUNT_BUCKETS",
    "DEFAULT_BUCKETS",
    "Histogram",
    "LOG_BUCKETS",
    "UNIT_BUCKETS",
    "get_gauge",
    "get_histogram",
    "histograms_summary",
    "observe",
    "ratio_gauge",
    "set_gauge",
)

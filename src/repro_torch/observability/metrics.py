"""Process-global metrics registry: counters, gauges, histograms.

Counterpart of the reference's ``repro.observability.metrics``, copied:
it is pure Python.

Zero dependencies, thread-safe, always-on (increments are two dict
lookups and an add — cheap enough that ``QRService.stats()`` is a thin
view over this registry).  Metrics are *labeled*: each metric name owns
a family of series keyed by a sorted ``(key, value)`` label tuple, so
two ``QRService`` instances (``service="qr-3"`` vs ``service="qr-4"``)
or two engine lowerings (``mode="megakernel"`` vs ``mode="wavefront"``)
never collide.

    from repro_torch.observability import metrics
    metrics.counter("engine.dispatches").inc(3)
    metrics.counter("planner.fallbacks", reason="tiled_min_dim_cpu_floor").inc()
    metrics.histogram("service.flush_latency_us").observe(1234.0)

Export:

  * :func:`snapshot` — plain-dict form (JSON-ready), used by the
    benchmark records and ``observability.report``.
  * :func:`to_prometheus` — Prometheus text exposition format.
  * :func:`reset` — drop all series (test isolation).

Histograms keep fixed log-spaced bucket counts plus exact
count/sum/min/max, and estimate percentiles from the bucket CDF —
bounded memory under million-request serving loads.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "reset",
    "snapshot",
    "to_prometheus",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count for one labeled series."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self.value += amount


class Gauge:
    """A value that can go up or down (queue depth, cache size)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


# Default buckets: log-spaced from 1 to 1e9 (covers microsecond
# latencies through multi-kilosecond runs and byte counts into the GB).
_DEFAULT_BUCKETS = tuple(10.0 ** (e / 3.0) for e in range(0, 28))


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    Percentiles interpolate within the matched bucket, so they are
    estimates (exact only when observations coincide with bounds) —
    the right trade for an always-on registry.
    """

    __slots__ = ("_lock", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, lock: threading.RLock,
                 bounds: Tuple[float, ...] = _DEFAULT_BUCKETS) -> None:
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +inf overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from bucket CDF."""
        with self._lock:
            if not self.count:
                return 0.0
            target = self.count * min(max(q, 0.0), 100.0) / 100.0
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= target and c:
                    lo = self.bounds[i - 1] if i > 0 else (
                        self.min if self.min != math.inf else 0.0)
                    hi = self.bounds[i] if i < len(self.bounds) else self.max
                    lo = max(lo, self.min)
                    hi = min(hi, self.max)
                    if hi < lo:
                        lo, hi = hi, hi
                    frac = (target - (seen - c)) / c
                    return lo + (hi - lo) * frac
            return self.max


class MetricsRegistry:
    """Name → {labelkey → instrument} map behind one RLock."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: Dict[str, Dict[LabelKey, Counter]] = {}
        self._gauges: Dict[str, Dict[LabelKey, Gauge]] = {}
        self._histograms: Dict[str, Dict[LabelKey, Histogram]] = {}

    def _series(self, table, name: str, labels: Dict[str, object], factory):
        key = _label_key(labels)
        fam = table.get(name)
        if fam is not None:
            inst = fam.get(key)
            if inst is not None:
                return inst
        with self._lock:
            fam = table.setdefault(name, {})
            inst = fam.get(key)
            if inst is None:
                inst = factory(self._lock)
                fam[key] = inst
            return inst

    def counter(self, name: str, **labels: object) -> Counter:
        return self._series(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels: object) -> Gauge:
        return self._series(self._gauges, name, labels, Gauge)

    def histogram(self, name: str, buckets: Optional[Iterable[float]] = None,
                  **labels: object) -> Histogram:
        if buckets is not None:
            bounds = tuple(sorted(float(b) for b in buckets))
            return self._series(self._histograms, name, labels,
                                lambda lock: Histogram(lock, bounds))
        return self._series(self._histograms, name, labels, Histogram)

    def counter_value(self, name: str, **labels: object) -> float:
        """Read a counter without creating it (0.0 if absent)."""
        fam = self._counters.get(name)
        if not fam:
            return 0.0
        inst = fam.get(_label_key(labels))
        return inst.value if inst is not None else 0.0

    def counter_total(self, name: str, **labels: object) -> float:
        """Sum a counter family over series matching the given labels."""
        fam = self._counters.get(name)
        if not fam:
            return 0.0
        want = set(_label_key(labels))
        with self._lock:
            return sum(c.value for key, c in fam.items()
                       if want <= set(key))

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready dump of every series (histograms summarized)."""
        with self._lock:
            out: Dict[str, object] = {"counters": {}, "gauges": {},
                                      "histograms": {}}
            for name, fam in sorted(self._counters.items()):
                out["counters"][name] = [
                    {"labels": dict(k), "value": c.value}
                    for k, c in sorted(fam.items())]
            for name, fam in sorted(self._gauges.items()):
                out["gauges"][name] = [
                    {"labels": dict(k), "value": g.value}
                    for k, g in sorted(fam.items())]
            for name, fam in sorted(self._histograms.items()):
                out["histograms"][name] = [
                    {"labels": dict(k), "count": h.count, "sum": h.sum,
                     "mean": h.mean,
                     "min": h.min if h.count else 0.0,
                     "max": h.max if h.count else 0.0,
                     "p50": h.percentile(50), "p90": h.percentile(90),
                     "p99": h.percentile(99)}
                    for k, h in sorted(fam.items())]
            return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (names get _total/_sum/...)."""

        def fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()):
            items = key + extra
            if not items:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + inner + "}"

        def sanitize(name: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)

        lines: List[str] = []
        with self._lock:
            for name, fam in sorted(self._counters.items()):
                pname = sanitize(name) + "_total"
                lines.append(f"# TYPE {pname} counter")
                for key, c in sorted(fam.items()):
                    lines.append(f"{pname}{fmt_labels(key)} {c.value:g}")
            for name, fam in sorted(self._gauges.items()):
                pname = sanitize(name)
                lines.append(f"# TYPE {pname} gauge")
                for key, g in sorted(fam.items()):
                    lines.append(f"{pname}{fmt_labels(key)} {g.value:g}")
            for name, fam in sorted(self._histograms.items()):
                pname = sanitize(name)
                lines.append(f"# TYPE {pname} histogram")
                for key, h in sorted(fam.items()):
                    cum = 0
                    for b, c in zip(h.bounds, h.counts):
                        cum += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{fmt_labels(key, (('le', f'{b:g}'),))} {cum}")
                    lines.append(
                        f"{pname}_bucket"
                        f"{fmt_labels(key, (('le', '+Inf'),))} {h.count}")
                    lines.append(f"{pname}_sum{fmt_labels(key)} {h.sum:g}")
                    lines.append(f"{pname}_count{fmt_labels(key)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()


def counter(name: str, **labels: object) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: object) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: Optional[Iterable[float]] = None,
              **labels: object) -> Histogram:
    return REGISTRY.histogram(name, buckets, **labels)


def counter_value(name: str, **labels: object) -> float:
    return REGISTRY.counter_value(name, **labels)


def counter_total(name: str, **labels: object) -> float:
    return REGISTRY.counter_total(name, **labels)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def reset() -> None:
    REGISTRY.reset()

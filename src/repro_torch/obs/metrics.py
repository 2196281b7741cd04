"""Typed metrics: counters, gauges, and bounded-reservoir histograms.

``ServeStats`` grew one ad-hoc int per PR and one unbounded ``*_samples``
list per latency distribution — O(ticks) host memory for the life of a run,
and no way for an exporter to discover what exists. :class:`MetricRegistry`
puts every metric behind one of three typed primitives:

* :class:`Counter` — a monotone-ish numeric cell (``+=`` per event);
* :class:`Gauge`   — a last-value cell (peaks, wall clocks);
* :class:`Reservoir` — a bounded histogram: exact ``count``/``total``/
  ``min_value``/``max_value`` plus an Algorithm-R uniform sample capped at
  ``cap`` values, so percentile queries stay O(cap) while the run streams
  millions of observations.

The reservoir is list-compatible on purpose: ``append``/``len``/``iter``/
``max()``/``np.mean`` all behave like the list it replaces, and while the
observation count is below ``cap`` (every tier-1 test and smoke bench) the
sample IS the full population — percentiles and means are bit-identical to
the unbounded implementation. The RNG is seeded per metric name, so runs
are deterministic regardless of host entropy.
"""
from __future__ import annotations

import random
import zlib
from typing import Dict, Optional

import numpy as np

DEFAULT_RESERVOIR_CAP = 4096


class Counter:
    """Monotone-ish numeric cell (the registry allows ``=`` for syncs from
    subsystem-owned counters, e.g. the prefix cache's)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value


class Gauge:
    """Last-value cell (peaks, accumulated wall seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0.0):
        self.name = name
        self.value = value


class Reservoir:
    """Bounded histogram: exact count/sum/min/max + Algorithm-R sample.

    Below ``cap`` observations the sample is the full population (queries
    are exact); past it, each new value replaces a uniformly random slot
    with probability cap/count, so the sample stays uniform over the whole
    stream while memory stays O(cap).
    """

    __slots__ = ("name", "cap", "count", "total", "min_value", "max_value",
                 "_samples", "_rng")

    def __init__(self, name: str = "", cap: int = DEFAULT_RESERVOIR_CAP):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.name = name
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.min_value: Optional[float] = None
        self.max_value: Optional[float] = None
        self._samples: list = []
        # deterministic per-metric stream: same run -> same sample set
        self._rng = random.Random(zlib.crc32(name.encode()) or 1)

    def append(self, x) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if self.min_value is None or x < self.min_value:
            self.min_value = x
        if self.max_value is None or x > self.max_value:
            self.max_value = x
        if len(self._samples) < self.cap:
            self._samples.append(x)
        else:  # Algorithm R: uniform over all count observations
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._samples[j] = x

    def extend(self, xs) -> None:
        for x in xs:
            self.append(x)

    # -- list compatibility (drop-in for the unbounded sample lists) ---------

    def __len__(self) -> int:
        return self.count  # observations seen, not sample slots held

    def __bool__(self) -> bool:
        return self.count > 0

    def __iter__(self):
        return iter(self._samples)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._samples, dtype=dtype)

    def __repr__(self) -> str:
        return (f"Reservoir({self.name!r}, count={self.count}, "
                f"mean={self.mean_value:.4g})")

    # -- queries -------------------------------------------------------------

    @property
    def mean_value(self) -> float:
        """Exact mean over ALL observations (``np.mean`` on the reservoir
        averages the bounded sample instead — named ``mean_value`` rather
        than ``mean`` so numpy's protocol lookup doesn't find a float
        attribute and falls through to ``__array__``)."""
        return self.total / self.count if self.count else 0.0

    @property
    def samples(self) -> list:
        return list(self._samples)

    def percentile(self, q) -> float:
        """Exact while count <= cap; reservoir-estimated past it."""
        if not self._samples:
            return 0.0
        return float(np.percentile(
            np.asarray(self._samples, np.float64), q))

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min_value, "max": self.max_value,
                "mean": round(self.mean_value, 6),
                "p50": round(self.percentile(50), 6),
                "p95": round(self.percentile(95), 6),
                "p99": round(self.percentile(99), 6)}


class MetricRegistry:
    """Named typed metrics with an export-friendly snapshot.

    One registry per engine run; ``ServeStats`` fronts one so legacy
    attribute access (``stats.calls += 1``) routes here unchanged.
    """

    def __init__(self, reservoir_cap: int = DEFAULT_RESERVOIR_CAP):
        self.reservoir_cap = reservoir_cap
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, value=0) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, value)
        return m

    def gauge(self, name: str, value=0.0) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name, value)
        return m

    def histogram(self, name: str,
                  cap: Optional[int] = None) -> Reservoir:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Reservoir(
                name, cap if cap is not None else self.reservoir_cap)
        return m

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> list:
        return sorted(self._metrics)

    def value(self, name: str):
        """Counter/gauge -> the number; histogram -> the Reservoir itself
        (so legacy ``stats.ttft_samples.append(...)`` keeps working)."""
        m = self._metrics[name]
        if isinstance(m, Reservoir):
            return m
        return m.value

    def set_value(self, name: str, value) -> None:
        m = self._metrics[name]
        if isinstance(m, Reservoir):
            raise TypeError(f"histogram {name!r} takes append(), not =")
        m.value = value

    def snapshot(self) -> dict:
        """{name: value-or-histogram-summary} for the metrics exporter."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.snapshot() if isinstance(m, Reservoir) else m.value
        return out


__all__ = ["Counter", "Gauge", "Reservoir", "MetricRegistry",
           "DEFAULT_RESERVOIR_CAP"]

"""Unified metrics registry: counters, gauges, streaming histograms.

Metric names follow a ``subsystem.metric`` scheme ("engine.ttft_ms",
"pool.allocs", "percolation.demote_bytes", "tier.evictions") so every
``stats()`` surface reads from one namespace.  Histograms are streaming
sketches — log-spaced sparse buckets, O(buckets) memory independent of
sample count — replacing the engines' unbounded per-completion latency
lists.  Count, sum (hence mean), min and max are tracked exactly;
quantiles interpolate within a bucket, so relative error is bounded by
the bucket growth factor (~1.5% at growth 1.03).
"""

import math

__all__ = ["Counter", "Gauge", "StreamingHistogram", "MetricsRegistry"]


class Counter:
    """Monotonic counter (reset only via reset())."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def reset(self):
        self.value = 0


class Gauge:
    """Last-write-wins value; set_max() tracks a running peak."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def set_max(self, v):
        if v > self.value:
            self.value = v

    def reset(self):
        self.value = 0


class StreamingHistogram:
    """Quantile sketch over positive samples in O(buckets) memory.

    Bucket i covers [GROWTH**i, GROWTH**(i+1)); non-positive samples go
    to a dedicated underflow bucket and are represented by the exact
    minimum.  quantile(q) walks the cumulative counts and interpolates
    linearly inside the containing bucket, clamped to [min, max] — so it
    is monotone in q and exact at the extremes.
    """

    GROWTH = 1.03
    _LOG_GROWTH = math.log(GROWTH)

    __slots__ = ("count", "sum", "min", "max", "_buckets", "_under")

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets = {}
        self._under = 0

    def record(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._under += 1
        else:
            i = math.floor(math.log(v) / self._LOG_GROWTH)
            self._buckets[i] = self._buckets.get(i, 0) + 1

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q):
        """q in [0, 100]."""
        if self.count == 0:
            return 0.0
        rank = (q / 100.0) * (self.count - 1)
        cum = self._under
        if rank < cum:
            return self.min
        lo_clamp, hi_clamp = self.min, self.max
        for i in sorted(self._buckets):
            n = self._buckets[i]
            if rank < cum + n:
                lo = self.GROWTH ** i
                hi = self.GROWTH ** (i + 1)
                frac = (rank - cum + 0.5) / n
                v = lo + (hi - lo) * frac
                return min(max(v, lo_clamp), hi_clamp)
            cum += n
        return self.max

    def snapshot(self):
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(50.0),
            "p95": self.quantile(95.0),
            "p99": self.quantile(99.0),
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }


class MetricsRegistry:
    """Get-or-create registry keyed by ``subsystem.metric`` names."""

    def __init__(self):
        self._metrics = {}

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name):
        return self._get(name, StreamingHistogram)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self):
        """Flat name -> value dict; histograms expand to name.stat."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, StreamingHistogram):
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out

    def reset(self):
        for m in self._metrics.values():
            m.reset()

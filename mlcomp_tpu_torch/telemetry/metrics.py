"""Bucketed latency histograms for the serving process (port of the
histogram half of ``mlcomp_tpu/telemetry/metrics.py``).

A serving process observes every request into an in-memory histogram
whose fixed-boundary counts are the cumulative ``le`` buckets /health
and an OpenMetrics scraper read. Flushing to the DB waits for the DB
slice of the port.
"""

import bisect
import threading


class Histogram:
    """Count, sum and fixed-boundary bucket counts."""

    __slots__ = ('count', 'total', 'bucket_bounds', '_bucket_counts')

    def __init__(self, buckets=None):
        self.count = 0
        self.total = 0.0
        self.bucket_bounds = sorted(float(b) for b in buckets) \
            if buckets else None
        # one count per bound plus the implicit +Inf overflow bucket
        self._bucket_counts = [0] * (len(self.bucket_bounds) + 1) \
            if self.bucket_bounds else None

    def observe(self, value: float):
        value = float(value)
        self.count += 1
        self.total += value
        if self.bucket_bounds is not None:
            self._bucket_counts[
                bisect.bisect_left(self.bucket_bounds, value)] += 1

    def bucket_counts(self):
        """CUMULATIVE ``[(le, count)]`` ending with ``('+Inf', total)``
        — the OpenMetrics histogram convention — or None when this
        histogram was built without buckets."""
        if self._bucket_counts is None:
            return None
        out, running = [], 0
        for bound, n in zip(self.bucket_bounds, self._bucket_counts):
            running += n
            out.append((bound, running))
        out.append(('+Inf', running + self._bucket_counts[-1]))
        return out


class MetricRecorder:
    """In-memory histograms keyed by name, safe across request
    threads."""

    def __init__(self, component: str = None):
        self.component = component
        self._histograms = {}
        self._mutate_lock = threading.Lock()

    def observe(self, name: str, value: float, buckets=None):
        """Histogram sample. ``buckets`` (upper bounds) apply on the
        FIRST observe of a name — later calls reuse the open
        histogram's boundaries (mixed bounds would corrupt the
        cumulative counts)."""
        with self._mutate_lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram(buckets=buckets)
            hist.observe(value)

    def histogram_snapshot(self, name: str):
        """``(bucket_counts, count, total)`` of one open histogram under
        the lock — ONE consistent view (a mid-observe read would break
        the +Inf-bucket == count invariant). None when absent."""
        with self._mutate_lock:
            hist = self._histograms.get(name)
            if hist is None:
                return None
            return hist.bucket_counts(), hist.count, hist.total


__all__ = ['Histogram', 'MetricRecorder']

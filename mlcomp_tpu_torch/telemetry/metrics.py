"""Metric series and latency histograms (port of
``mlcomp_tpu/telemetry/metrics.py``).

A serving process observes every request into an in-memory histogram
whose fixed-boundary counts are the cumulative ``le`` buckets /health
and an OpenMetrics scraper read; a timed chain (``ops/serving_stack.py``
``make_chain_runner``) observes its per-stack times, whose
``histogram_summaries()`` (count, mean, min, max, p50/p95/p99 over a
bounded reservoir) a harness prints. A recorder with a DB session
flushes its gauges and histogram summaries into ``metric`` rows, every
``FLUSH_EVERY`` samples and on ``flush()``.

Recording never syncs the device: callers hand the recorder host
floats, taken where their step already syncs. A CUDA tensor handed in
is not pulled at flush either — it is counted in ``dropped_count``.
"""

import bisect
import json
import threading
import weakref
from collections import deque

import numpy as np

#: pending samples that trigger a flush, and the most a flush keeps
FLUSH_EVERY = 100
CAPACITY = 65536

#: session-bound recorders alive in this process, drained by the task
#: process's crash-time flush (worker/tasks.py) so the telemetry of a
#: failed task is not lost with the process. Weak: registration must
#: not keep a finished executor's recorder alive.
_LIVE_RECORDERS = weakref.WeakSet()


def flush_live_recorders() -> int:
    """Best-effort flush of every live session-bound recorder; returns
    the rows written. Never raises: it runs on the interpreter's way
    down."""
    total = 0
    for recorder in list(_LIVE_RECORDERS):
        try:
            total += recorder.flush()
        except Exception:
            pass
    return total


class Histogram:
    """Count, sum, min, max, a bounded reservoir for percentiles and,
    with ``buckets``, fixed-boundary counts."""

    __slots__ = ('count', 'total', 'min', 'max', '_reservoir',
                 'bucket_bounds', '_bucket_counts')

    def __init__(self, reservoir: int = 1024, buckets=None):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._reservoir = deque(maxlen=reservoir)
        self.bucket_bounds = sorted(float(b) for b in buckets) \
            if buckets else None
        # one count per bound plus the implicit +Inf overflow bucket
        self._bucket_counts = [0] * (len(self.bucket_bounds) + 1) \
            if self.bucket_bounds else None

    def observe(self, value: float):
        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self._reservoir.append(value)
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

    def summary(self) -> dict:
        """count, mean, min, max and the reservoir's p50/p95/p99; {}
        before the first sample."""
        if not self.count:
            return {}
        window = list(self._reservoir)
        return {
            'count': float(self.count),
            'mean': self.total / self.count,
            'min': self.min, 'max': self.max,
            'p50': float(np.percentile(window, 50)),
            'p95': float(np.percentile(window, 95)),
            'p99': float(np.percentile(window, 99)),
        }


def _host_float(value):
    """``float(value)``, or None for a value that lives on a device."""
    if getattr(value, 'is_cuda', False):
        return None
    return float(np.asarray(value))


class MetricRecorder:
    """Gauges and histograms keyed by name, safe across request
    threads; with a ``session``, flushed into ``metric`` rows of
    ``task``."""

    def __init__(self, session=None, task: int = None,
                 component: str = None):
        self.session = session
        self.task = task
        self.component = component
        self._pending = []        # (name, kind, step, value)
        self._histograms = {}
        self._hist_flushed_counts = {}
        self._mutate_lock = threading.Lock()
        self.dropped_count = 0
        self.flushed_count = 0
        if session is not None:
            _LIVE_RECORDERS.add(self)

    def _maybe_flush(self):
        if len(self._pending) >= FLUSH_EVERY \
                and self.session is not None:
            self.flush()

    def gauge(self, name: str, value, step: int = None):
        """Per-step sample (a host float)."""
        with self._mutate_lock:
            self._pending.append((name, 'gauge', step, value))
        self._maybe_flush()

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

    def histogram_summaries(self) -> dict:
        """Live snapshot ``{name: summary_dict}`` of the open
        histograms."""
        with self._mutate_lock:
            return {name: h.summary()
                    for name, h in self._histograms.items()}

    # ----------------------------------------------------------- flush path
    def _materialize(self):
        """Swap out pending samples and aggregate snapshots as ``metric``
        rows. Bucketed histograms stay open and emit cumulative
        snapshots (only when they saw new samples); bucket-less ones
        emit their window's summary and reset."""
        from mlcomp_tpu_torch.utils.misc import now
        with self._mutate_lock:
            pending, self._pending = self._pending, []
            hists = self._histograms
            self._histograms = {name: h for name, h in hists.items()
                                if h.bucket_bounds is not None}
            hist_snapshots = {}
            for name, h in hists.items():
                if h.bucket_bounds is not None and \
                        self._hist_flushed_counts.get(name) == h.count:
                    continue
                self._hist_flushed_counts[name] = h.count
                hist_snapshots[name] = (h.summary(), h.bucket_counts())
        if len(pending) > CAPACITY:
            self.dropped_count += len(pending) - CAPACITY
            pending = pending[-CAPACITY:]
        ts = now()
        rows = []
        for name, kind, step, value in pending:
            try:
                value = _host_float(value)
            except (TypeError, ValueError):
                value = None
            if value is None:
                self.dropped_count += 1
                continue
            rows.append((self.task, name, kind, step, value, ts,
                         self.component, None))
        for name, (summary, buckets) in hist_snapshots.items():
            for stat, v in summary.items():
                rows.append((self.task, f'{name}.{stat}', 'histogram',
                             None, float(v), ts, self.component,
                             json.dumps({'of': name})))
            for le, count in buckets or ():
                rows.append((self.task, f'{name}.bucket', 'histogram',
                             None, float(count), ts, self.component,
                             json.dumps({'of': name, 'le': le})))
        return rows

    def flush(self, session=None) -> int:
        """Persist everything pending in one batch; returns the rows
        written. Telemetry failures never propagate into the
        instrumented code: rows that do not land are counted dropped."""
        session = session or self.session
        rows = self._materialize()
        if not rows:
            return 0
        if session is None:
            self.dropped_count += len(rows)
            return 0
        from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
        try:
            n = MetricProvider(session).add_many(rows)
        except Exception:
            self.dropped_count += len(rows)
            return 0
        self.flushed_count += n
        if self.task is not None:
            # a flush is proof of life for the watchdog's stall rule
            try:
                from mlcomp_tpu_torch.db.providers.task import TaskProvider
                TaskProvider(session).update_last_activity(self.task)
            except Exception:
                pass
        return n


__all__ = ['Histogram', 'MetricRecorder']

"""Metric series, counters and latency histograms (port of
``mlcomp_tpu/telemetry/metrics.py``).

The rule that makes this usable inside a training loop: **recording
never syncs the device**. ``series('loss', metrics['loss'], step)``
appends the 0-d CUDA tensor itself; the pull to the host happens at
flush, once per ``flush_every`` samples, as ONE stacked copy per device
for the whole window, then one ``executemany``. With ``async_flush`` the
flush a full window triggers runs on a background thread: its ``.cpu()``
waits for the stream there, never inside the wrapped train step.

A serving process observes every request into an in-memory histogram
whose fixed-boundary counts are the cumulative ``le`` buckets /health
and an OpenMetrics scraper read; a timed chain (``ops/serving_stack.py``
``make_chain_runner``) observes its per-stack times, whose
``histogram_summaries()`` (count, mean, min, max, p50/p95/p99 over a
bounded reservoir) a harness prints. Counters and histograms aggregate
in memory and emit summary rows at flush.
"""

import bisect
import itertools
import json
import threading
import weakref
from collections import deque

import numpy as np

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


def _host_values(values) -> list:
    """``values`` as host floats (None where a value is not a number):
    the 0-d tensors among them come over in one stacked copy per device
    (a per-scalar ``float()`` would wait for the device once each)."""
    out = list(values)
    by_device = {}
    for i, v in enumerate(out):
        if hasattr(v, 'detach') and hasattr(v, 'device'):
            if v.numel() == 1:
                by_device.setdefault(v.device, []).append(i)
            else:
                out[i] = None       # an unreduced tensor: unusable
    if by_device:
        import torch
        for idx in by_device.values():
            stacked = torch.stack(
                [out[i].detach().reshape(()).float() for i in idx])
            for i, v in zip(idx, stacked.cpu().tolist()):
                out[i] = v
    for i, v in enumerate(out):
        if v is None or isinstance(v, float):
            continue
        try:
            out[i] = float(np.asarray(v))
        except (TypeError, ValueError):
            out[i] = None
    return out


class MetricRecorder:
    """One recorder per (task, component). Bind a session to persist;
    without one it is a pure in-memory buffer (tests, the serving
    histograms).

    Thread safety: every mutation holds ``_mutate_lock``, so a
    concurrent flush (serving heartbeat, ``async_flush`` worker) swaps
    the buffers without losing racing samples. ``async_flush=True``
    moves the flush a full window triggers onto a background daemon
    thread; explicit ``flush()`` calls stay synchronous."""

    def __init__(self, session=None, task: int = None,
                 component: str = None, flush_every: int = 100,
                 capacity: int = 65536, async_flush: bool = False):
        self.session = session
        self.task = task
        self.component = component
        self.flush_every = max(1, int(flush_every))
        self.capacity = int(capacity)
        self.async_flush = bool(async_flush)
        self._pending = []        # (name, kind, step, value) — hot path
        self._counters = {}
        self._histograms = {}
        self._hist_flushed_counts = {}
        self._mutate_lock = threading.Lock()
        self._flush_thread = None
        self._steps = itertools.count()
        self.dropped_count = 0
        self.flushed_count = 0
        if session is not None:
            _LIVE_RECORDERS.add(self)

    # ------------------------------------------------------------ hot path
    def _maybe_flush(self):
        # an approximate trigger by design: a racy len() can only defer
        # or add one flush (taking the lock here would deadlock: flush()
        # takes it and Lock is not reentrant)
        if len(self._pending) < self.flush_every or self.session is None:
            return
        if not self.async_flush:
            self.flush()
            return
        t = self._flush_thread
        if t is not None and t.is_alive():
            return              # one in-flight flush is enough
        t = threading.Thread(target=self.flush, daemon=True,
                             name='telemetry-flush')
        self._flush_thread = t
        t.start()

    def series(self, name: str, value, step: int = None):
        """Per-step sample. ``value`` may be a CUDA tensor: it is NOT
        converted here (no device sync on the hot path)."""
        with self._mutate_lock:
            self._pending.append((name, 'series', step, value))
        self._maybe_flush()

    def gauge(self, name: str, value, step: int = None):
        with self._mutate_lock:
            self._pending.append((name, 'gauge', step, value))
        self._maybe_flush()

    def count(self, name: str, inc: float = 1):
        with self._mutate_lock:
            self._counters[name] = self._counters.get(name, 0.0) + inc

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

    def next_step(self) -> int:
        return next(self._steps)

    def histogram_summaries(self) -> dict:
        """Live snapshot ``{name: summary_dict}`` of the open
        histograms."""
        with self._mutate_lock:
            return {name: h.summary()
                    for name, h in self._histograms.items()}

    def series_array(self, name: str, values, start_step: int = 0):
        """Bulk append of a [steps] array (one host pull for all)."""
        arr = np.asarray(values).reshape(-1)
        with self._mutate_lock:
            for i, v in enumerate(arr):
                self._pending.append((name, 'series', start_step + i,
                                      float(v)))

    # ----------------------------------------------------------- flush path
    def _materialize(self):
        """Swap out pending samples and aggregate snapshots as ``metric``
        rows, values pulled to the host HERE (off the hot path).
        Bucketed histograms stay open and emit cumulative snapshots
        (only when they saw new samples); bucket-less ones emit their
        window's summary and reset."""
        from mlcomp_tpu_torch.utils.misc import now
        with self._mutate_lock:
            pending, self._pending = self._pending, []
            counters, self._counters = self._counters, {}
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
        if len(pending) > self.capacity:
            self.dropped_count += len(pending) - self.capacity
            pending = pending[-self.capacity:]
        ts = now()
        rows = []
        values = _host_values(v for (_, _, _, v) in pending)
        for (name, kind, step, _), value in zip(pending, values):
            if value is None:
                self.dropped_count += 1
                continue
            rows.append((self.task, name, kind, step, value, ts,
                         self.component, None))
        for name, total in counters.items():
            rows.append((self.task, name, 'counter', None, float(total),
                         ts, self.component, None))
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

    def close(self) -> int:
        """Join an in-flight background flush, then flush the rest
        synchronously: every recorded sample is in the DB or counted
        dropped."""
        t = self._flush_thread
        if t is not None and t.is_alive():
            t.join(timeout=30)
        return self.flush()


__all__ = ['Histogram', 'MetricRecorder', 'flush_live_recorders']

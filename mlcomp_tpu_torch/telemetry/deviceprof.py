"""Sampled device-time profiling (port of
``mlcomp_tpu/telemetry/deviceprof.py``).

Every ``profile_every`` steps the train loop captures a short
``torch.profiler`` window (``profile_steps`` dispatches, CPU and CUDA
activities) into a temp dir; the parser (telemetry/trace_parse.py) turns
the dump into a device-time attribution which persists as ``devtime.*``
metric series:

- ``devtime.compute_ms`` / ``devtime.comm_ms`` /
  ``devtime.comm_exposed_ms`` / ``devtime.io_ms`` /
  ``devtime.idle_ms`` — per sampled window, summed across device lines
  (``compute + io + comm_exposed + idle == window x lines``);
- ``devtime.busy_frac`` / ``devtime.exposed_comm_frac``;
- ``devtime.window_ms`` / ``devtime.host_dispatch_gap_ms`` — window
  extent (first kernel to last) and the host's time between the
  window's step dispatches;
- ``devtime.summary`` — one row per window whose tags carry the bucket
  split and the top kernels (the postmortem bundle and the dashboard
  card read this).

Each train-step call made while a trace runs (a window, an on-demand
or an epoch trace) is bracketed by a ``ProfilerStep#<step>`` annotation
(``step_marker``, train/loop.py ``instrumented_step``): the trace's
dispatch events, as JAX's ``PjitFunction(...)`` are. ``torch.profiler``'s
own ``prof.step()`` marks would run from one step's end to the next and
leave no gap between dispatches to measure.

Cost model: the hot path is ONE integer comparison per step
(``on_step``); a window pays the
profiler's start and stop (and the trace's export) on the loop thread,
while parse and DB write run on a background daemon thread, at most one
in flight: a window whose predecessor is still parsing is skipped, never
queued. The first start in a process initialises Kineto (and CUPTI on
the card), which takes seconds on the loop thread: the engine logs it.
Kineto runs one profiler at a time, so a window open at teardown is
closed (``close``, ``close_live_profilers``) before anything else
profiles, and ``blocked`` keeps windows shut while another trace of the
trainer runs.
"""

import os
import shutil
import socket
import tempfile
import threading
import time
import weakref

#: default capture cadence/extent: one window of 3 dispatches every
#: 1000 steps (the trainer opens none unless ``profile_every`` asks)
DEFAULT_EVERY = 1000
DEFAULT_WINDOW = 3

#: series written per window (export.py maps the *_ms ones onto
#: mlcomp_devtime_ms{bucket=...})
BUCKET_SERIES = ('compute_ms', 'comm_ms', 'comm_exposed_ms', 'io_ms',
                 'idle_ms')

_LIVE_PROFILERS = weakref.WeakSet()


def close_live_profilers() -> int:
    """Teardown flush for crash/exit paths (worker SIGTERM/atexit —
    same contract as metrics.flush_live_recorders): close every live
    engine so an open capture window still lands as devtime.* rows."""
    n = 0
    for prof in list(_LIVE_PROFILERS):
        try:
            prof.close()
            n += 1
        except Exception:
            pass
    return n


def persist_attribution(session, task_id: int, attr: dict,
                        step: int = None,
                        component: str = 'train') -> int:
    """Write one sampled window's attribution as ``devtime.*`` rows
    (one ``add_many`` batch). ``step`` stamps the window with the
    train step that opened it so windows order on the step axis."""
    import json as _json

    from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
    from mlcomp_tpu_torch.utils.misc import now
    ts = now()
    buckets = attr.get('buckets') or {}
    rows = []
    for key in BUCKET_SERIES:
        rows.append((task_id, f'devtime.{key}', 'series', step,
                     float(buckets.get(key, 0.0)), ts, component,
                     None))
    rows.append((task_id, 'devtime.busy_frac', 'series', step,
                 float(attr.get('busy_frac', 0.0)), ts, component,
                 None))
    rows.append((task_id, 'devtime.exposed_comm_frac', 'series', step,
                 float(attr.get('exposed_comm_frac', 0.0)), ts,
                 component, None))
    rows.append((task_id, 'devtime.window_ms', 'series', step,
                 float(attr.get('window_ms', 0.0)), ts, component,
                 None))
    host = attr.get('host') or {}
    rows.append((task_id, 'devtime.host_dispatch_gap_ms', 'series',
                 step, float(host.get('dispatch_gap_ms', 0.0)), ts,
                 component, None))
    rows.append((task_id, 'devtime.summary', 'gauge', step,
                 float(attr.get('window_ms', 0.0)), ts, component,
                 _json.dumps({
                     'buckets': buckets,
                     'busy_frac': attr.get('busy_frac', 0.0),
                     'exposed_comm_frac':
                         attr.get('exposed_comm_frac', 0.0),
                     'device_lines': attr.get('device_lines', 0),
                     'host': host,
                     'ops': (attr.get('ops') or [])[:8],
                 })))
    MetricProvider(session).add_many(rows)
    return len(rows)


def step_marker(step: int):
    """The annotation a step dispatch runs under while a trace runs:
    the parser's dispatch event (``ProfilerStep#<step>``)."""
    from torch.profiler import record_function
    return record_function(f'ProfilerStep#{step}')


class TorchTracer:
    """``torch.profiler`` behind JAX's ``start_trace(dir)`` /
    ``stop_trace()`` shape: ``stop`` writes the capture as
    ``<dir>/plugins/profile/<stamp>/<host>.trace.json.gz``. CUDA
    activity is recorded with ``cuda``; the CPU's always."""

    def __init__(self, cuda: bool = False):
        self.cuda = bool(cuda)
        self._prof = None
        self._dir = None

    def start(self, out_dir: str):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, out_dir

    def stop(self) -> str:
        """Stop and write the capture; returns the file's path."""
        prof, self._prof = self._prof, None
        if prof is None:
            raise RuntimeError('no trace is running')
        prof.stop()
        stamp = time.strftime('%Y_%m_%d_%H_%M_%S') + \
            f'_{time.time_ns() % 10 ** 9:09d}'
        folder = os.path.join(self._dir, 'plugins', 'profile', stamp)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f'{socket.gethostname()}.trace.json.gz')
        prof.export_chrome_trace(path)
        return path


class DeviceProfiler:
    """Sampled capture engine driven from the instrumented step.

    ``on_step(step)`` is the only hot-path entry: opens a window when
    ``step`` hits the cadence, counts dispatches while one is open, and
    hands the dump to a background parse+persist when it closes. The
    tracer callables are injectable for tests (default: a
    ``TorchTracer``); ``blocked()`` true skips a cadence hit.
    """

    def __init__(self, session, task_id: int,
                 every: int = DEFAULT_EVERY,
                 window: int = DEFAULT_WINDOW,
                 component: str = 'train', logger=None,
                 tracer_start=None, tracer_stop=None, parser=None,
                 cuda: bool = False, blocked=None):
        self.session = session
        self.task_id = task_id
        self.every = int(every)
        self.window = max(1, int(window))
        self.component = component
        self.logger = logger
        if tracer_start is None or tracer_stop is None:
            tracer = TorchTracer(cuda=cuda)
            tracer_start = tracer_start or tracer.start
            tracer_stop = tracer_stop or tracer.stop
        self._start = tracer_start
        self._stop = tracer_stop
        self._parser = parser
        self._blocked = blocked
        self.windows = 0          # completed (persisted) windows
        self.failures = 0
        self.skipped = 0          # cadence hits skipped (parse busy)
        self.start_seconds = []   # the tracer's start time, per window
        self.capturing = False
        self._steps_in_window = 0
        self._window_step = None
        self._dir = None
        self._parse_thread = None
        if session is not None:
            _LIVE_PROFILERS.add(self)

    # ------------------------------------------------------------ hot path
    def on_step(self, step: int):
        if self.capturing:
            self._steps_in_window += 1
            if self._steps_in_window >= self.window:
                self._close_window()
            return
        if self.every > 0 and step and step % self.every == 0:
            self._open_window(step)

    # ------------------------------------------------------------- windows
    def _log(self, message: str):
        if self.logger:
            self.logger(message)

    def _open_window(self, step: int):
        t = self._parse_thread
        if (t is not None and t.is_alive()) or \
                (self._blocked is not None and self._blocked()):
            # previous window still parsing, or another trace runs:
            # skip, never queue
            self.skipped += 1
            return
        out = tempfile.mkdtemp(prefix=f'devprof_{self.task_id}_')
        t0 = time.perf_counter()
        try:
            self._start(out)
        except Exception as e:
            shutil.rmtree(out, ignore_errors=True)
            self.failures += 1
            self._log(f'deviceprof: start_trace failed ({e})')
            return
        self.start_seconds.append(time.perf_counter() - t0)
        if len(self.start_seconds) == 1:
            self._log(f'deviceprof: the first window\'s profiler start '
                      f'took {self.start_seconds[0]:.2f} s on the loop '
                      f'thread (a process\'s first start initialises '
                      f'Kineto, and CUPTI on the card: seconds)')
        self._dir = out
        self._window_step = step
        self._steps_in_window = 0
        self.capturing = True

    def _close_window(self, wait: bool = False):
        self.capturing = False
        try:
            self._stop()
        except Exception as e:
            self.failures += 1
            self._log(f'deviceprof: stop_trace failed ({e})')
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
            return
        out, self._dir = self._dir, None
        step = self._window_step
        t = threading.Thread(target=self._parse_and_persist,
                             args=(out, step), daemon=True,
                             name='deviceprof-parse')
        self._parse_thread = t
        t.start()
        if wait:
            t.join(timeout=60)

    def _parse_and_persist(self, out_dir: str, step):
        try:
            parser = self._parser
            if parser is None:
                from mlcomp_tpu_torch.telemetry.trace_parse import \
                    parse_trace_dir
                parser = parse_trace_dir
            attr = parser(out_dir)
            if self.session is not None:
                persist_attribution(self.session, self.task_id, attr,
                                    step=step,
                                    component=self.component)
        except Exception as e:
            self.failures += 1
            self._log(f'deviceprof: window parse failed ({e})')
            shutil.rmtree(out_dir, ignore_errors=True)
            return
        # cleanup BEFORE the counter ticks: `windows` is the "this
        # window fully landed" signal (close() and the tests key on it)
        shutil.rmtree(out_dir, ignore_errors=True)
        self.windows += 1

    def end_window(self):
        """Close an open window now (its parse runs in the background):
        the trainer calls this where its steps stop, so a window holds
        train steps only, and before another trace starts."""
        if self.capturing:
            self._close_window()

    def close(self):
        """Flush on teardown: an open window stops + parses
        synchronously (bounded), an in-flight parse gets joined so its
        rows land before the process exits."""
        if self.capturing:
            self._close_window(wait=True)
        t = self._parse_thread
        if t is not None and t.is_alive():
            t.join(timeout=60)


def prune_profile_dirs(root: str, keep: int = 3) -> int:
    """Keep only the ``keep`` newest captures under a profile dir
    (``root/plugins/profile/<stamp>/``, the layout ``TorchTracer``
    writes);
    returns how many were removed. The on-demand profiler
    (telemetry/profiler.py) calls this after every parse-on-stop so
    repeated trace requests stop accumulating dumps forever — the
    postmortem-retention pattern applied to trace dirs."""
    capture_root = os.path.join(root, 'plugins', 'profile')
    if not os.path.isdir(capture_root):
        return 0
    stamps = sorted(
        (d for d in (os.path.join(capture_root, n)
                     for n in os.listdir(capture_root))
         if os.path.isdir(d)),
        key=os.path.getmtime, reverse=True)
    removed = 0
    for d in stamps[max(0, int(keep)):]:
        shutil.rmtree(d, ignore_errors=True)
        removed += 1
    return removed


__all__ = ['DeviceProfiler', 'TorchTracer', 'step_marker',
           'persist_attribution',
           'prune_profile_dirs', 'close_live_profilers',
           'BUCKET_SERIES', 'DEFAULT_EVERY', 'DEFAULT_WINDOW']

"""Runtime compile and host-sync detection (port of
``mlcomp_tpu/telemetry/compile_events.py``).

What the port compiles at run time is its CUDA kernels: ``ops/_build.py``
runs ``nvcc`` for a kernel whose library is missing, at the kernel's
first launch, and times each build. The port uses no ``torch.compile``,
so there are no dynamo hooks to listen to.

- ``CompileEventRecorder`` listens to those builds
  (``_build.BUILD_LISTENERS``) and records each as a
  ``compile.backend_ms`` sample carrying the triggering train step, and
  counts ``compile.count`` — the series the JAX package's readers (the
  dashboard's recompile timeline, ``/metrics``'
  ``mlcomp_compile_events``) take.
- ``HostSyncTripwire`` watches the host-observed inter-dispatch interval
  the instrumented step already measures, and flags steps that blow
  past a multiple of the rolling median (and an absolute floor) as
  ``host_sync.suspect_ms`` samples — the signature of a blocking
  device-to-host copy inside the step path. A step that built a kernel
  is exempt (slow for a known reason).

Hot-path cost: the listener runs only when a kernel builds; the tripwire
is one comparison per step against a cached median.
"""

import statistics
import time
from collections import deque

#: the event name a kernel build records under
COMPILE_EVENTS = ('nvcc_build',)


class CompileEventRecorder:
    """Record kernel builds as metric samples with the triggering step.

    The instrumented step (train/loop.py) stamps ``self.step`` each
    step, so a build fired from inside the step lands with the step
    number that triggered it.
    """

    def __init__(self, recorder=None, metric='compile.backend_ms',
                 max_events=512):
        self.recorder = recorder
        self.metric = metric
        self.step = None          # stamped by the instrumented step
        self.events = deque(maxlen=max_events)
        self.installed = False
        self._dirty = False       # a build landed since last consume
        self._listener = None

    def install(self) -> bool:
        """Listen to ``ops/_build.py``'s builds."""
        if self.installed:
            return True
        from mlcomp_tpu_torch.ops import _build

        def _on_build(name, seconds):
            step = self.step
            self.events.append({'event': COMPILE_EVENTS[0],
                                'kernel': name,
                                'duration_s': float(seconds),
                                'step': step, 'ts': time.time()})
            self._dirty = True
            if self.recorder is not None:
                self.recorder.series(self.metric, float(seconds) * 1e3,
                                     step=step)
                self.recorder.count('compile.count')

        _build.BUILD_LISTENERS.append(_on_build)
        self._listener = _on_build
        self.installed = True
        return True

    def uninstall(self):
        """Stop listening: a persistent worker's next task must not
        record builds into a finished task's recorder. ``events`` stays
        readable."""
        self.recorder = None
        if self._listener is None:
            return
        from mlcomp_tpu_torch.ops import _build
        try:
            _build.BUILD_LISTENERS.remove(self._listener)
        except ValueError:
            pass
        self._listener = None
        self.installed = False

    def consume_dirty(self) -> bool:
        """True iff a build landed since the previous call — the
        tripwire's exemption signal."""
        dirty, self._dirty = self._dirty, False
        return dirty


class HostSyncTripwire:
    """Flag steps whose host-observed interval says "something inside
    the step blocked the host" — a device→host transfer in the step
    path, after the pipeline should be async.

    ``observe(dt_ms)`` is called with the inter-dispatch interval the
    instrumented step already computes. After ``warmup_steps`` clean
    samples, an interval above ``max(min_ms, factor x rolling
    median)`` records a ``host_sync.suspect_ms`` sample (and is kept
    OUT of the baseline, so one sync can't teach the tripwire that
    syncs are normal).
    """

    def __init__(self, recorder=None, factor=20.0, min_ms=50.0,
                 warmup_steps=10, window=64, refresh_every=16,
                 metric='host_sync.suspect_ms'):
        self.recorder = recorder
        self.factor = float(factor)
        self.min_ms = float(min_ms)
        self.warmup_steps = int(warmup_steps)
        self.metric = metric
        self.suspects = 0
        self._times = deque(maxlen=int(window))
        self._median = None
        self._since_refresh = 0
        self._refresh_every = max(1, int(refresh_every))

    def observe(self, dt_ms: float, step=None) -> bool:
        dt_ms = float(dt_ms)
        if len(self._times) >= self.warmup_steps:
            if self._median is None or \
                    self._since_refresh >= self._refresh_every:
                self._median = statistics.median(self._times)
                self._since_refresh = 0
            self._since_refresh += 1
            threshold = max(self.min_ms, self.factor * self._median)
            if dt_ms > threshold:
                self.suspects += 1
                if self.recorder is not None:
                    self.recorder.series(self.metric, dt_ms, step=step)
                    self.recorder.count('host_sync.suspect_count')
                return True
        self._times.append(dt_ms)
        return False


__all__ = ['CompileEventRecorder', 'HostSyncTripwire', 'COMPILE_EVENTS']

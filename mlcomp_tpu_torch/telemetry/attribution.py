"""Per-step phase attribution (port of
``mlcomp_tpu/telemetry/attribution.py``): why is a step slow?

``StepAttribution`` splits every production step into four phases by
reading a monotonic clock at boundaries the loop ALREADY crosses — no
extra device syncs, no code restructuring:

- ``data_wait``  — pulling the next batch from the input pipeline
  (shuffle/augment on the host path, taking the step's index row on
  the device-data path)
- ``h2d``        — the host-to-device copy of the batch (pinned,
  ``non_blocking``), or of the epoch's indices on the device-data path
- ``compute``    — the train-step call. CUDA launches are asynchronous:
  this is the host's time to launch the step's kernels, which tracks
  the device's step time only once the launch queue fills and pushes
  back. The device's own side comes from the sampled ``devtime``
  windows (telemetry/deviceprof.py)
- ``telemetry``  — the recorder appends + this module's own emission

Each phase mark is ONE ``perf_counter`` read and a float add; a step
ends with four buffered ``series`` appends (``step.phase.<ph>_ms``).
Epoch boundaries emit the derived ``step.pipeline_efficiency`` gauge
(compute share of the attributed wall-clock).
"""

import time

#: attribution phases, in hot-loop order
PHASES = ('data_wait', 'h2d', 'compute', 'telemetry')


class StepAttribution:
    """Phase clock for one training loop (one instance per executor).

    ``begin(phase)`` attributes the time since the previous mark to the
    phase that was open and opens the new one; ``step_end()`` closes
    the step, emits the per-step ``step.phase.*`` series into
    ``recorder`` and accumulates epoch totals. Thread-unsafe by design:
    it lives on the training loop's thread only.
    """

    def __init__(self, recorder=None):
        self.recorder = recorder
        self.steps = 0
        self._open = None
        self._t_open = None
        self._step_ms = {}
        self._epoch_ms = {}

    # ------------------------------------------------------------ hot path
    def begin(self, phase, now=None):
        """Open ``phase``, attributing the elapsed interval to the
        previously open one. ``begin(None)`` just closes."""
        t = time.perf_counter() if now is None else now
        if self._open is not None:
            ms = (t - self._t_open) * 1e3
            self._step_ms[self._open] = \
                self._step_ms.get(self._open, 0.0) + ms
        self._open = phase
        self._t_open = t

    def step_end(self, step=None, now=None):
        """Close the step: per-step phase series into the recorder
        (buffered appends — no device sync), totals into the epoch."""
        self.begin(None, now=now)
        step_ms, self._step_ms = self._step_ms, {}
        self.steps += 1
        for phase, ms in step_ms.items():
            self._epoch_ms[phase] = self._epoch_ms.get(phase, 0.0) + ms
        if self.recorder is not None:
            for phase, ms in step_ms.items():
                self.recorder.series(f'step.phase.{phase}_ms', ms,
                                     step=step)

    # ------------------------------------------------------------ epoch end
    def totals_ms(self):
        return dict(self._epoch_ms)

    def efficiency(self):
        """Compute share of the attributed wall-clock this epoch, or
        None before any attributed step."""
        total = sum(self._epoch_ms.values())
        if total <= 0:
            return None
        return self._epoch_ms.get('compute', 0.0) / total

    def emit_epoch(self, recorder=None, epoch=None):
        """Emit ``step.pipeline_efficiency`` (+ reset for the next
        epoch). Returns ``{'efficiency', 'steps', 'totals_ms'}`` so
        callers (bench) can read the numbers without a DB trip."""
        rec = recorder if recorder is not None else self.recorder
        out = {'efficiency': self.efficiency(), 'steps': self.steps,
               'totals_ms': self.totals_ms()}
        if rec is not None and out['efficiency'] is not None:
            rec.gauge('step.pipeline_efficiency', out['efficiency'],
                      step=epoch)
        self.reset_epoch()
        return out

    def reset_epoch(self):
        self.steps = 0
        self._epoch_ms = {}
        self._step_ms = {}
        self._open = None
        self._t_open = None


__all__ = ['StepAttribution', 'PHASES']

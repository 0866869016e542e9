"""On-demand ``torch.profiler`` traces, toggled per task through the API
(port of ``mlcomp_tpu/telemetry/profiler.py``).

``POST /api/telemetry/profile {task, action}`` writes a request row
into the auxiliary table, and the training process polls it at epoch
boundaries via ``TaskProfiler`` — zero overhead between polls, no new
transport. The tracer is ``deviceprof.TorchTracer``, which writes the
capture where the parser looks
(``<dir>/plugins/profile/<stamp>/<host>.trace.json.gz``); the trainer's
``profile: {epochs, dir}`` key uses the same tracer.

Row lifecycle under key ``telemetry:profile:<task>``:
``requested`` → (worker starts trace) → ``tracing`` → on a ``stop``
request or ``max_epochs`` elapsed → ``done`` (with the trace dir).

Parse-on-stop: the ``done`` row also carries the device-time
``attribution`` (telemetry/trace_parse.py over the fresh dump, also
persisted as ``devtime.*`` rows), and the capture dir is pruned to the
newest ``KEEP_CAPTURES`` dumps. A failed parse degrades to the
path-only ``done`` row — never an error.
"""

import os
import time

AUX_PREFIX = 'telemetry:profile:'

#: on-demand capture retention per task dir (the postmortem-retention
#: pattern applied to trace dumps)
KEEP_CAPTURES = 3


def _provider(session):
    from mlcomp_tpu_torch.db.providers import AuxiliaryProvider
    return AuxiliaryProvider(session)


def request_trace(session, task_id: int, out_dir: str = None,
                  max_epochs: int = 1) -> dict:
    """API side: ask the worker running ``task_id`` to start a trace."""
    row = {'status': 'requested', 'dir': out_dir,
           'max_epochs': int(max_epochs), 'ts': time.time()}
    _provider(session).create_or_update(
        f'{AUX_PREFIX}{task_id}', row)
    return row


def request_stop(session, task_id: int) -> dict:
    prov = _provider(session)
    key = f'{AUX_PREFIX}{task_id}'
    row = dict(prov.get().get(key) or {})
    row.update({'status': 'stop_requested', 'ts': time.time()})
    prov.create_or_update(key, row)
    return row


def trace_status(session, task_id: int) -> dict:
    return _provider(session).get().get(
        f'{AUX_PREFIX}{task_id}') or {'status': 'none'}


class TaskProfiler:
    """Worker side: poll the request row and drive the profiler.

    ``poll()`` is called at epoch boundaries (cheap: one SELECT). The
    tracer callables are injectable for tests; the default is a
    ``TorchTracer`` (CUDA activity with ``cuda``).
    """

    def __init__(self, session, task_id: int, default_dir: str,
                 tracer_start=None, tracer_stop=None, cuda: bool = False):
        self.session = session
        self.task_id = task_id
        self.default_dir = default_dir
        if tracer_start is None or tracer_stop is None:
            from mlcomp_tpu_torch.telemetry.deviceprof import TorchTracer
            tracer = TorchTracer(cuda=cuda)
            tracer_start = tracer_start or tracer.start
            tracer_stop = tracer_stop or tracer.stop
        self._start = tracer_start
        self._stop = tracer_stop
        self.tracing = False
        self._epochs_traced = 0
        self._max_epochs = 1
        self._dir = None

    def _key(self):
        return f'{AUX_PREFIX}{self.task_id}'

    def _write(self, row: dict):
        try:
            _provider(self.session).create_or_update(self._key(), row)
        except Exception:
            pass

    def _read(self) -> dict:
        try:
            return _provider(self.session).get().get(self._key()) or {}
        except Exception:
            return {}

    def poll(self) -> bool:
        """Advance the state machine one step; returns whether a trace
        is running AFTER the poll."""
        if self.session is None:
            return False
        row = self._read()
        status = row.get('status')
        if not self.tracing and status == 'requested':
            self._dir = row.get('dir') or os.path.join(
                self.default_dir, 'profile_on_demand')
            self._max_epochs = int(row.get('max_epochs') or 1)
            try:
                self._start(self._dir)
            except Exception as e:
                self._write(dict(row, status='failed', error=str(e)))
                return False
            self.tracing = True
            self._epochs_traced = 0
            self._write(dict(row, status='tracing', dir=self._dir))
            return True
        if self.tracing:
            self._epochs_traced += 1
            if status == 'stop_requested' \
                    or self._epochs_traced >= self._max_epochs:
                self._finish(row)
        return self.tracing

    def _finish(self, row: dict):
        try:
            self._stop()
        except Exception:
            pass
        self.tracing = False
        done = dict(row, status='done', dir=self._dir,
                    epochs=self._epochs_traced)
        # parse-on-stop: attach the device-time attribution and land
        # it as devtime.* rows; any failure degrades to the path-only
        # answer above (the dump may be absent, truncated, or in a
        # format the parser has never seen)
        try:
            from mlcomp_tpu_torch.telemetry.deviceprof import (
                persist_attribution, prune_profile_dirs,
            )
            from mlcomp_tpu_torch.telemetry.trace_parse import \
                parse_trace_dir
            attr = parse_trace_dir(self._dir)
            done['attribution'] = attr
            try:
                persist_attribution(self.session, self.task_id, attr)
            except Exception:
                pass
            prune_profile_dirs(self._dir, keep=KEEP_CAPTURES)
        except Exception:
            pass
        self._write(done)

    def close(self):
        """Stop an open trace (exception paths) so a restarted executor
        can start a fresh one."""
        if self.tracing:
            self._finish(self._read())


__all__ = ['TaskProfiler', 'request_trace', 'request_stop',
           'trace_status', 'AUX_PREFIX', 'KEEP_CAPTURES']

"""Deterministic fault injection for the port's production seams (port
of ``mlcomp_tpu/testing/faults.py``, same spec format and the same
``MLCOMP_FAULTS`` environment variable).

With no faults configured ``fault_point`` returns after one
module-global check. A fault fires on the Nth hit of its point
(``after``, default 1) for ``times`` hits (default 1; None = every hit
from ``after`` on); ``when`` filters hits by the site's context kwargs.
Actions: ``exit`` (``os._exit(code)``, default 137), ``raise`` (``exc``:
operational / oserror / runtime / resource) and ``sleep`` (``ms``).

The serving seams: ``serve.request``, ``replica.slow`` and
``replica.crash`` (ctx ``model``; ``phase='request'`` for the crash).
``replica.crash`` also fires in the ``serve_replica`` executor's
heartbeat (worker/executors/serve_replica.py, ctx ``phase='beat'`` with
``fleet`` and ``replica``), so a ``when`` filter kills exactly one
replica of a fleet. The control plane's: ``supervisor.preempt`` (ctx
``task``, ``initiator``), between an eviction's decision row and its
kill, and ``sweep.prune``; the trainer's ``train.epoch``.
"""

import json
import os
import sqlite3
import time

FAULTS_ENV = 'MLCOMP_FAULTS'

#: point -> spec dict (with a mutable '_hits' counter). None = the
#: disabled fast path.
_ACTIVE = None

_EXCEPTIONS = {
    'operational': lambda msg: sqlite3.OperationalError(
        msg or 'database is locked (injected)'),
    'oserror': lambda msg: OSError(msg or 'connection reset (injected)'),
    'runtime': lambda msg: RuntimeError(msg or 'injected fault'),
    'resource': lambda msg: RuntimeError(
        msg or 'RESOURCE_EXHAUSTED: Out of memory allocating '
               '17179869184 bytes (injected)'),
}


def configure_faults(specs: dict):
    """Arm the registry with ``{point: spec}``, replacing any previous
    configuration and resetting every hit counter."""
    global _ACTIVE
    if not specs:
        _ACTIVE = None
        return
    active = {}
    for point, spec in specs.items():
        spec = dict(spec or {})
        spec.setdefault('action', 'raise')
        spec.setdefault('after', 1)
        spec.setdefault('times', 1)
        spec['_hits'] = 0
        active[point] = spec
    _ACTIVE = active


def clear_faults():
    global _ACTIVE
    _ACTIVE = None


def fault_point(name: str, **ctx):
    """A production seam announces a hit. Disabled: one global check."""
    if _ACTIVE is None:
        return
    spec = _ACTIVE.get(name)
    if spec is None:
        return
    when = spec.get('when')
    if when and any(ctx.get(k) != v for k, v in when.items()):
        return
    spec['_hits'] += 1
    hit = spec['_hits']
    after = int(spec.get('after') or 1)
    times = spec.get('times')
    if hit < after:
        return
    if times is not None and hit >= after + int(times):
        return
    action = spec.get('action')
    if action == 'exit':
        os._exit(int(spec.get('code', 137)))  # noqa — simulated SIGKILL
    if action == 'raise':
        raise _EXCEPTIONS.get(spec.get('exc', 'runtime'),
                              _EXCEPTIONS['runtime'])(spec.get('message'))
    if action == 'sleep':
        time.sleep(float(spec.get('ms', 10)) / 1000.0)
        return
    raise ValueError(f'unknown fault action {action!r} for {name!r}')


_env = os.environ.get(FAULTS_ENV)
if _env:
    try:
        configure_faults(json.loads(_env))
    except (ValueError, TypeError):
        _ACTIVE = None


__all__ = ['fault_point', 'configure_faults', 'clear_faults',
           'FAULTS_ENV']

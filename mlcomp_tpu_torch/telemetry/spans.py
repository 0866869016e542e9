"""Tracing spans: context managers buffered in a thread-safe ring,
flushed to the DB in batches off the hot path (port of
``mlcomp_tpu/telemetry/spans.py``).

Answering "where did the wall-clock of DAG 7 go?" needs timestamps from
INSIDE the system, on one clock, with parent/child structure — the task
row's started/finished pair can't split executor-import from training
from checkpointing. A span records (span_id, parent_id, task, name,
wall start, monotonic duration, tags); nesting is tracked per-thread so
``with span('a'): with span('b'): ...`` links b→a without the caller
threading ids around.

Cross-process trace context (Dapper-style propagation): every span also
carries a ``trace_id`` and a ``process_role``. The trace id is minted
once per DAG submission and travels supervisor → queue payload → worker
environment → task subprocess, so the supervisor's dispatch span, the
worker's pipeline spans and the train loop's spans for one task join
into ONE trace even though their process-scoped span ids never cross a
process boundary. ``set_trace_context`` stores the pair process-wide
AND exports it as ``MLCOMP_TRACE_ID`` / ``MLCOMP_PROCESS_ROLE`` env
vars, which this module reads back at import — a fresh subprocess
inherits the trace with zero plumbing in between.

Hot-path cost: entering a span is two ``perf_counter`` calls and a list
push; exiting appends one dict to a bounded deque. Nothing touches the
DB until ``flush_spans(session)`` (typically once per task, or on a
flush cadence) hands the drained batch to one ``executemany``. When the
ring overflows, the OLDEST spans drop and ``dropped_count`` says so —
telemetry must never grow without bound inside a worker.
"""

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

_counter = itertools.count(1)
_tls = threading.local()

TRACE_ID_ENV = 'MLCOMP_TRACE_ID'
PROCESS_ROLE_ENV = 'MLCOMP_PROCESS_ROLE'

#: process-wide trace context, seeded from the environment so a
#: subprocess that inherits the environment joins the trace on import
_trace_context = {
    'trace_id': os.environ.get(TRACE_ID_ENV) or None,
    'process_role': os.environ.get(PROCESS_ROLE_ENV) or None,
}


def new_trace_id() -> str:
    """Globally-unique trace id (hex, 16 chars) — minted once per DAG
    submission; span ids stay process-scoped, the trace id is what crosses
    process boundaries."""
    return uuid.uuid4().hex[:16]


def set_trace_context(trace_id, process_role=None):
    """Bind this process's spans to a trace. Also exports the pair as
    env vars so any subprocess spawned with the inherited environment
    continues the trace automatically. ``set_trace_context(None)``
    clears BOTH halves (context and env) — a traceless task in a
    persistent worker must not inherit the previous task's role."""
    _trace_context['trace_id'] = trace_id
    if trace_id:
        os.environ[TRACE_ID_ENV] = str(trace_id)
    else:
        os.environ.pop(TRACE_ID_ENV, None)
    if process_role is not None:
        _trace_context['process_role'] = process_role
        os.environ[PROCESS_ROLE_ENV] = str(process_role)
    elif not trace_id:
        _trace_context['process_role'] = None
        os.environ.pop(PROCESS_ROLE_ENV, None)


def get_trace_context():
    """(trace_id, process_role) currently bound to this process."""
    return _trace_context['trace_id'], _trace_context['process_role']


#: per-process id prefix: pid plus a random component — pid alone
#: collides across HOSTS (two containers both running pid 42 would
#: interleave span ids inside one cross-process trace and corrupt the
#: assembled parentage)
_PROC_PREFIX = f'{os.getpid():x}.{uuid.uuid4().hex[:6]}'


def _new_span_id() -> str:
    # process-scoped: batch inserts from concurrent workers can't collide
    return f'{_PROC_PREFIX}-{next(_counter):x}'


def _stack():
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class SpanBuffer:
    """Bounded thread-safe ring of finished spans."""

    def __init__(self, capacity: int = 4096):
        self._ring = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped_count = 0

    def add(self, record: dict):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped_count += 1
            self._ring.append(record)

    def drain(self):
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def __len__(self):
        return len(self._ring)


#: process-wide default buffer — the worker pipeline and the executors
#: share it so one flush at task end captures everything
DEFAULT_BUFFER = SpanBuffer()


class _SpanHandle:
    __slots__ = ('span_id', 'tags')

    def __init__(self, span_id, tags):
        self.span_id = span_id
        self.tags = tags

    def tag(self, key, value):
        self.tags[key] = value


@contextmanager
def span(name: str, task: int = None, tags: dict = None,
         buffer: SpanBuffer = None, trace_id: str = None,
         role: str = None):
    """Trace the enclosed block. Nested spans parent automatically
    (per-thread); ``task`` defaults to the enclosing span's task so
    only the root span of a task needs to carry it. ``trace_id`` /
    ``role`` default to the process trace context (set_trace_context),
    so cross-process joining costs nothing at each call site."""
    buf = buffer if buffer is not None else DEFAULT_BUFFER
    stack = _stack()
    parent_id, parent_task = (stack[-1] if stack else (None, None))
    handle = _SpanHandle(_new_span_id(), dict(tags or {}))
    if task is None:
        task = parent_task
    stack.append((handle.span_id, task))
    started = time.time()
    t0 = time.perf_counter()
    status = 'ok'
    try:
        yield handle
    except BaseException:
        status = 'error'
        raise
    finally:
        duration = time.perf_counter() - t0
        stack.pop()
        buf.add({
            'span_id': handle.span_id, 'parent_id': parent_id,
            'task': task, 'name': name, 'started': started,
            'duration': duration, 'status': status,
            'tags': handle.tags or None,
            'trace_id': trace_id if trace_id is not None
            else _trace_context['trace_id'],
            'process_role': role if role is not None
            else _trace_context['process_role'],
        })


def record_span(name: str, started: float, duration: float,
                task: int = None, tags: dict = None, status: str = 'ok',
                buffer: SpanBuffer = None, trace_id: str = None,
                role: str = None) -> str:
    """Record an ALREADY-measured interval as a span — for code that
    timed a phase itself (e.g. the train loop's epoch timer) and would
    otherwise need a whole-body re-indent to use the context manager.
    Parents to the enclosing open span like a nested ``with span``
    would; returns the new span id."""
    buf = buffer if buffer is not None else DEFAULT_BUFFER
    stack = _stack()
    parent_id, parent_task = (stack[-1] if stack else (None, None))
    if task is None:
        task = parent_task
    span_id = _new_span_id()
    buf.add({
        'span_id': span_id, 'parent_id': parent_id, 'task': task,
        'name': name, 'started': started, 'duration': duration,
        'status': status, 'tags': dict(tags) if tags else None,
        'trace_id': trace_id if trace_id is not None
        else _trace_context['trace_id'],
        'process_role': role if role is not None
        else _trace_context['process_role'],
    })
    return span_id


def flush_spans(session, buffer: SpanBuffer = None) -> int:
    """Drain the buffer into one batched insert. Returns rows written.
    Failures are swallowed after re-buffering nothing — telemetry loss
    must never fail the task it observes."""
    buf = buffer if buffer is not None else DEFAULT_BUFFER
    records = buf.drain()
    if not records or session is None:
        return 0
    from mlcomp_tpu_torch.db.providers.telemetry import TelemetrySpanProvider
    rows = [(r['span_id'], r['parent_id'], r['task'], r['name'],
             r['started'], r['duration'], r['status'],
             json.dumps(r['tags']) if r['tags'] else None,
             r.get('trace_id'), r.get('process_role'))
            for r in records]
    try:
        return TelemetrySpanProvider(session).add_many(rows)
    except Exception:
        return 0


__all__ = ['span', 'record_span', 'flush_spans', 'SpanBuffer',
           'DEFAULT_BUFFER', 'new_trace_id', 'set_trace_context',
           'get_trace_context', 'TRACE_ID_ENV', 'PROCESS_ROLE_ENV']

"""Tracing spans into an in-memory ring (port of the recording half of
``mlcomp_tpu/telemetry/spans.py``).

The serving process records a ``serve.predict`` span for each request
that carries a trace id; the spans wait in ``DEFAULT_BUFFER``. Flushing
them to the DB waits for the DB slice of the port.
"""

import itertools
import os
import threading
import uuid
from collections import deque

_counter = itertools.count(1)

#: per-process id prefix: pid plus a random part (pid alone collides
#: across hosts)
_PROC_PREFIX = f'{os.getpid():x}.{uuid.uuid4().hex[:6]}'


class SpanBuffer:
    """Bounded thread-safe ring of finished spans; the oldest drop when
    it overflows and ``dropped_count`` says so."""

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


DEFAULT_BUFFER = SpanBuffer()


def record_span(name: str, started: float, duration: float,
                task: int = None, tags: dict = None, status: str = 'ok',
                buffer: SpanBuffer = None, trace_id: str = None,
                role: str = None) -> str:
    """Record an ALREADY-measured interval as a root span of trace
    ``trace_id`` (the port has no nesting ``span`` context manager yet).
    Returns the span id."""
    buf = buffer if buffer is not None else DEFAULT_BUFFER
    span_id = f'{_PROC_PREFIX}-{next(_counter):x}'
    buf.add({
        'span_id': span_id, 'parent_id': None, 'task': task,
        'name': name, 'started': started, 'duration': duration,
        'status': status, 'tags': dict(tags) if tags else None,
        'trace_id': trace_id, 'process_role': role,
    })
    return span_id


__all__ = ['record_span', 'SpanBuffer', 'DEFAULT_BUFFER']

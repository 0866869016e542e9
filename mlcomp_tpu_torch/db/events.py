"""Wake-on-work event bus (port of ``mlcomp_tpu/db/events.py``).

Dispatch latency is bounded below by the supervisor's tick plus the
worker's queue poll wherever no wakeup can be delivered. This bus
removes that floor where one can, and degrades to the short poll where
it cannot:

====================  =========================================
deployment            wakeup transport
====================  =========================================
same process          in-process condition variable (always on)
plain sqlite,         none: waiters fall back to the short-poll
multi-process         timeout they pass in (``QUEUE_POLL_INTERVAL``)
====================  =========================================

(The JAX package's third row, ``LISTEN/NOTIFY`` across processes on
PostgreSQL, waits with the PostgreSQL backend: ROADMAP.md, A0.)

One process-wide :class:`LocalEventBus` holds a monotonically increasing
sequence number per channel under one ``threading.Condition``.
``publish`` bumps the channel and notifies; ``wait`` blocks until any
watched channel moves past the snapshot taken at entry, so a publish
that lands between the caller's "queue is empty" check and its
``wait`` is never lost.

Channels are plain strings:

- ``queue:{name}`` — a message was enqueued on that queue (workers)
- ``queue:done``   — a claimed message completed or failed (supervisor)
- ``tasks``        — a task row appeared or changed status (supervisor)
- ``supervisor:lease`` — the leader released its lease (standbys)
"""

import threading
import time

CH_QUEUE_PREFIX = 'queue:'
CH_QUEUE_DONE = 'queue:done'
CH_TASKS = 'tasks'
#: published when the leader releases its lease: a standby in this
#: process promotes at once (db/providers/supervisor.py)
CH_SUPERVISOR_LEASE = 'supervisor:lease'

#: reconnects of a cross-process listener, the ``db.listener_reconnects``
#: series' source; stays 0 until a backend with a listener is ported
_LISTENER_STATS_LOCK = threading.Lock()
_LISTENER_STATS = {'reconnects': 0}


def listener_stats() -> dict:
    """Snapshot of this process's listener reconnect counter."""
    with _LISTENER_STATS_LOCK:
        return dict(_LISTENER_STATS)


def record_listener_reconnect():
    with _LISTENER_STATS_LOCK:
        _LISTENER_STATS['reconnects'] += 1


def queue_channel(queue: str) -> str:
    return CH_QUEUE_PREFIX + queue


class LocalEventBus:
    """Per-channel sequence counters under one condition variable."""

    def __init__(self):
        self._cond = threading.Condition()
        self._seq = {}          # channel -> int
        self.published_count = 0

    def publish(self, channel: str):
        with self._cond:
            self._seq[channel] = self._seq.get(channel, 0) + 1
            self.published_count += 1
            self._cond.notify_all()

    def snapshot(self, channels):
        with self._cond:
            return {c: self._seq.get(c, 0) for c in channels}

    def wait(self, channels, timeout: float,
             snapshot: dict = None) -> bool:
        """Block until any of ``channels`` is published past
        ``snapshot`` (taken at entry when not supplied) or ``timeout``
        elapses; True when woken by an event. Pass a snapshot taken
        BEFORE the caller's own emptiness check to close the
        check-then-wait race."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            if snapshot is None:
                snapshot = {c: self._seq.get(c, 0) for c in channels}
            while True:
                if any(self._seq.get(c, 0) > snapshot.get(c, 0)
                       for c in channels):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)


#: the process-wide bus every Session publishes into
LOCAL_BUS = LocalEventBus()


def publish(channel: str):
    LOCAL_BUS.publish(channel)


def wait(channels, timeout: float, snapshot: dict = None) -> bool:
    return LOCAL_BUS.wait(channels, timeout, snapshot=snapshot)


def snapshot(channels) -> dict:
    return LOCAL_BUS.snapshot(channels)


__all__ = ['LocalEventBus', 'LOCAL_BUS', 'publish', 'wait', 'snapshot',
           'queue_channel', 'CH_QUEUE_PREFIX', 'CH_QUEUE_DONE',
           'CH_TASKS', 'CH_SUPERVISOR_LEASE', 'listener_stats',
           'record_listener_reconnect']

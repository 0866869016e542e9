"""Supervisor high availability: the leader-lease state machine (port
of ``mlcomp_tpu/server/ha.py``).

Any number of ``mlcomp_tpu_torch.server start-site`` processes can run
the supervisor loop; exactly one leads at a time. :class:`LeaderLease`
is each process's handle on the election (db/providers/supervisor.py):

- a **standby** calls :meth:`ensure` every loop iteration; it acquires
  the lease the moment it is vacant or expired and otherwise parks on
  the ``supervisor:lease`` event channel (so an explicit release —
  graceful shutdown, rolling restart — promotes a standby of the same
  process in milliseconds; on sqlite the event does not cross
  processes, and a standby elsewhere retries at :attr:`standby_wait_s`,
  a third of the lease window);
- the **leader** renews a third of the way into each window; a failed
  renew means a newer epoch exists — the process demotes itself
  immediately and its :class:`~mlcomp_tpu_torch.db.fencing.FencedSession`
  (which reads ``lease.epoch`` per statement) already rejects whatever
  its paused threads were about to write;
- :meth:`release` drops the lease explicitly on shutdown.

The epoch this handle exposes is the fencing token the supervisor's
session stamps into every control-state mutation — the lease and the
fence are two views of the same integer, which is what makes the
split-brain window closeable at all.
"""

import os
import secrets
import time

from mlcomp_tpu_torch.db.providers.supervisor import (
    CH_SUPERVISOR_LEASE, SupervisorLeaseProvider,
)
from mlcomp_tpu_torch.utils.misc import hostname

#: default lease window — a SIGKILL'd leader is replaced within this
#: bound (an explicitly released one within milliseconds). Chosen well
#: above tick cost and DB hiccup scale, well below "operator notices".
DEFAULT_LEASE_SECONDS = 15.0

#: renew when this fraction of the window has passed — two more
#: chances before expiry if one renew hits a transient DB error
RENEW_FRACTION = 1.0 / 3.0


def supervisor_identity() -> str:
    """'{host}:{pid}:{nonce}' — unique per PROCESS INCARNATION. The
    nonce matters: a restarted supervisor reusing host+pid must look
    like a new contender (its old incarnation's epoch, if any, stays
    fenced off)."""
    return f'{hostname()}:{os.getpid()}:{secrets.token_hex(3)}'


class LeaderLease:
    """One process's view of the supervisor leader election."""

    def __init__(self, session, holder: str = None,
                 lease_seconds: float = DEFAULT_LEASE_SECONDS):
        #: the RAW session — the lease protocol itself must never ride
        #: a fenced wrapper (acquiring is what creates the epoch)
        self.session = session
        self.provider = SupervisorLeaseProvider(session)
        self.holder = holder or supervisor_identity()
        self.lease_seconds = float(lease_seconds)
        #: the fencing token while leading, None as a standby. Read by
        #: FencedSession per statement; written only by the loop
        #: thread (ensure/release) — a torn read is impossible (GIL
        #: object swap) and staleness is exactly what the DB-side
        #: fence predicate exists to catch.
        self.epoch = None
        self._renew_deadline = 0.0
        self.promotions = 0         # acquisitions by THIS process
        self.demotions = 0          # renews lost / leadership stolen
        self._last_roster = 0.0
        self.provider.ensure_row()

    # ------------------------------------------------------------ state
    @property
    def is_leader(self) -> bool:
        return self.epoch is not None

    @property
    def standby_wait_s(self) -> float:
        """How long a standby parks between acquire attempts (the
        lease channel wakes it earlier on explicit release)."""
        return max(0.2, self.lease_seconds * RENEW_FRACTION)

    def ensure(self) -> bool:
        """Acquire-or-renew; returns True while this process leads.
        Called once per loop iteration — cheap when leading (a
        conditional UPDATE only past the renew deadline)."""
        if self.epoch is not None:
            if time.monotonic() < self._renew_deadline:
                self._roster('leader')
                return True
            if self.provider.renew(self.holder, self.epoch,
                                   self.lease_seconds):
                self._arm_renew()
                self._roster('leader')
                return True
            # demoted: someone acquired past our expiry — our epoch is
            # stale and the store-side fence already rejects our writes
            self.epoch = None
            self.demotions += 1
            self._roster('standby', force=True)
            return False
        epoch = self.provider.try_acquire(self.holder,
                                          self.lease_seconds)
        if epoch is None:
            self._roster('standby')
            return False
        self.epoch = int(epoch)
        self.promotions += 1
        self._arm_renew()
        self._roster('leader', force=True)
        return True

    def _arm_renew(self):
        self._renew_deadline = time.monotonic() \
            + self.lease_seconds * RENEW_FRACTION

    def wait_standby(self, timeout: float = None) -> bool:
        """Park until the lease channel publishes (explicit release by
        the leader) or the acquire-retry backstop elapses. True when
        woken by the event — the caller should retry acquire NOW."""
        timeout = self.standby_wait_s if timeout is None else timeout
        try:
            return self.session.wait_event(
                [CH_SUPERVISOR_LEASE], timeout)
        except Exception:
            time.sleep(min(1.0, timeout))
            return False

    def release(self) -> bool:
        """Explicit drop (graceful shutdown): the standby's promotion
        latency collapses from a lease window to the event-bus wakeup.
        Safe to call as a standby (no-op)."""
        if self.epoch is None:
            return False
        ok = self.provider.release(self.holder, self.epoch)
        self.epoch = None
        if ok:
            self._roster('released', force=True)
        return ok

    # ----------------------------------------------------------- roster
    ROSTER_EVERY_S = 2.0

    def _roster(self, role: str, force: bool = False):
        """Heartbeat this process's ``supervisor_instance`` row —
        rate-limited, best-effort (the roster is monitoring, never a
        dependency of the election)."""
        stamp = time.monotonic()
        if not force and stamp - self._last_roster < self.ROSTER_EVERY_S:
            return
        self._last_roster = stamp
        try:
            self.provider.heartbeat_instance(
                self.holder, role, self.epoch or 0)
        except Exception:
            pass


class StaticLease:
    """A lease handle that always holds a FIXED epoch — the zombie
    stand-in for tests and chaos drills: wrap a FencedSession around
    one of these to replay what a paused ex-leader would write."""

    def __init__(self, epoch):
        self.epoch = epoch
        self.is_leader = epoch is not None


__all__ = ['LeaderLease', 'StaticLease', 'supervisor_identity',
           'DEFAULT_LEASE_SECONDS', 'CH_SUPERVISOR_LEASE']

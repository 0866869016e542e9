"""Supervisor lease + roster provider — the leader-election protocol
(port of ``mlcomp_tpu/db/providers/supervisor.py``).

Everything here is a CONDITIONAL single-statement write on the seeded
``supervisor_lease`` singleton (migration v12), so one SQL statement is
the whole protocol on sqlite (serialized by the file's writer lock):

- ``try_acquire`` wins only when the lease is vacant or expired, and
  BUMPS the epoch — the fencing token every supervisor-issued mutation
  is conditioned on (db/fencing.py);
- ``renew`` extends the expiry only while ``holder`` AND ``epoch``
  still match the caller — a renew that returns False IS the demotion
  signal (someone else acquired past our expiry; our epoch is stale
  and the fence already rejects our writes);
- ``release`` vacates the lease explicitly (graceful shutdown /
  rolling restart) so a standby promotes in milliseconds instead of
  waiting out a lease window — the release publishes on the
  ``supervisor:lease`` event channel, which standbys park on.

Clocks: expiry compares application ``now()`` timestamps — the same
convention every other lease in the system uses (queue claims, docker
heartbeats), so the deployment constraint (hosts loosely NTP-synced,
skew well under the lease window) is one rule, not two.
"""

import datetime

from mlcomp_tpu_torch.db.events import CH_SUPERVISOR_LEASE
from mlcomp_tpu_torch.db.models import SupervisorInstance, SupervisorLease
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class SupervisorLeaseProvider(BaseDataProvider):
    model = SupervisorLease

    def _publish(self):
        try:
            self.session.publish_event(CH_SUPERVISOR_LEASE)
        except Exception:
            pass        # best-effort: standbys keep a timer backstop

    def ensure_row(self):
        """Defensive twin of the migration seed (a legacy DB migrated
        mid-flight by another process may race this — the guarded
        INSERT below is idempotent)."""
        row = self.session.query_one(
            'SELECT id FROM supervisor_lease WHERE id=1')
        if row is None:
            try:
                self.session.execute(
                    'INSERT INTO supervisor_lease (id, holder, epoch) '
                    'VALUES (1, NULL, 0)')
            except Exception:
                pass    # unique-pk race: the other writer seeded it

    def current(self) -> SupervisorLease:
        row = self.session.query_one(
            'SELECT * FROM supervisor_lease WHERE id=1')
        return SupervisorLease.from_row(row) if row else None

    def try_acquire(self, holder: str, lease_seconds: float):
        """Take the lease if it is vacant, expired, or already ours —
        one conditional UPDATE that bumps the fencing epoch. Returns
        the NEW epoch on success, None when a live leader holds it.

        Re-acquisition by the current holder also bumps the epoch:
        a holder calls this (instead of ``renew``) only after losing
        track of its own epoch (a restart reusing the identity), and
        the stale incarnation's writes must be fenced off."""
        stamp = now()
        cur = self.session.execute(
            'UPDATE supervisor_lease SET holder=?, epoch=epoch+1, '
            'expires_at=?, acquired_at=?, renewed_at=? '
            'WHERE id=1 AND (holder IS NULL OR holder=? '
            'OR expires_at IS NULL OR expires_at < ?)',
            (holder,
             stamp + datetime.timedelta(seconds=float(lease_seconds)),
             stamp, stamp, holder, stamp))
        if cur.rowcount == 0:
            return None
        # read the epoch our update wrote. If a rival acquired between
        # our UPDATE and this read (possible only once OUR lease
        # already expired — we just set it a full window out, so in
        # practice never), holder no longer matches and we report the
        # loss instead of adopting the rival's epoch.
        row = self.current()
        if row is not None and row.holder == holder:
            return int(row.epoch)
        return None

    def renew(self, holder: str, epoch: int,
              lease_seconds: float) -> bool:
        """Extend the expiry — only while we still lead at OUR epoch.
        False means demoted: a newer epoch exists (or the row vanished)
        and the caller must stop acting as leader immediately."""
        stamp = now()
        cur = self.session.execute(
            'UPDATE supervisor_lease SET expires_at=?, renewed_at=? '
            'WHERE id=1 AND holder=? AND epoch=?',
            (stamp + datetime.timedelta(seconds=float(lease_seconds)),
             stamp, holder, int(epoch)))
        return cur.rowcount > 0

    def release(self, holder: str, epoch: int) -> bool:
        """Vacate the lease explicitly (graceful shutdown). Conditional
        on holder+epoch so a stale ex-leader can never vacate a NEWER
        leader's lease. Publishes the lease channel — the hot standby
        wakes and promotes in the same instant instead of sleeping out
        the expiry window."""
        cur = self.session.execute(
            'UPDATE supervisor_lease SET holder=NULL, expires_at=NULL '
            'WHERE id=1 AND holder=? AND epoch=?',
            (holder, int(epoch)))
        if cur.rowcount > 0:
            self._publish()
            return True
        return False

    # ---------------------------------------------------------- roster
    def heartbeat_instance(self, holder: str, role: str, epoch: int):
        """Upsert this process's roster row. Conditional-UPDATE-then-INSERT keyed on the
        unique holder string; monitoring only — the lease row stays
        the single source of truth for leadership."""
        stamp = now()
        host = holder.split(':', 1)[0]
        pid = None
        parts = holder.split(':')
        if len(parts) >= 2 and parts[1].isdigit():
            pid = int(parts[1])
        cur = self.session.execute(
            'UPDATE supervisor_instance SET role=?, epoch=?, '
            'last_seen=?, computer=?, pid=? WHERE holder=?',
            (role, int(epoch or 0), stamp, host, pid, holder))
        if cur.rowcount == 0:
            try:
                self.session.add(SupervisorInstance(
                    holder=holder, computer=host, pid=pid, role=role,
                    epoch=int(epoch or 0), started=stamp,
                    last_seen=stamp))
            except Exception:
                pass    # unique(holder) race with a twin heartbeat

    def instances(self):
        rows = self.session.query(
            'SELECT * FROM supervisor_instance ORDER BY id')
        return [SupervisorInstance.from_row(r) for r in rows]

    def prune_instances(self, silence_seconds: float = 3600.0):
        """Drop roster rows silent for an hour — dead supervisors must
        not accumulate forever in a long-lived deployment."""
        cutoff = now() - datetime.timedelta(
            seconds=float(silence_seconds))
        self.session.execute(
            'DELETE FROM supervisor_instance WHERE last_seen IS NOT '
            'NULL AND last_seen < ?', (cutoff,))


__all__ = ['SupervisorLeaseProvider', 'CH_SUPERVISOR_LEASE']

"""Supervisor high-availability models (migration v12).

The supervisor was the control plane's last single point of failure:
one unreplicated process drove dispatch, lease reclaim, watchdog kills
and fleet reconciliation. These two tables make it replicable:

- ``supervisor_lease`` — ONE row (id=1, seeded by the migration) that
  is the leader election: ``holder`` names the current leader,
  ``epoch`` is the fencing token (bumped by every acquisition, never
  by a renew), ``expires_at`` bounds how long a silent leader keeps
  the lease. Acquire/renew/release are conditional UPDATEs on this
  row (db/providers/supervisor.py) — the same statement works on
  sqlite and Postgres, so any number of ``mlcomp_tpu_torch server``
  processes can run: one leads, the rest hot-standby.
- ``supervisor_instance`` — the roster: every supervisor process
  (leader or standby) heartbeats a row here so ``mlcomp_tpu_torch
  supervisors`` and the dashboard can show who is alive, who leads,
  and at which epoch.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class SupervisorLease(DBModel):
    __tablename__ = 'supervisor_lease'

    #: always 1 — the migration seeds the singleton row so acquisition
    #: is a pure conditional UPDATE (no INSERT race to resolve)
    id = Column('INTEGER', primary_key=True)
    #: '{host}:{pid}:{nonce}' of the current leader; NULL = vacant
    holder = Column('TEXT')
    #: the fencing token: monotonically increasing, bumped by every
    #: ACQUISITION (a renew keeps it). Every supervisor-issued mutation
    #: is conditioned on this value (db/fencing.py), so a zombie
    #: ex-leader's writes are rejected the moment a newer epoch exists.
    epoch = Column('INTEGER', default=0)
    #: lease expiry — a standby may take over past this instant
    expires_at = Column('TEXT', dtype='datetime')
    acquired_at = Column('TEXT', dtype='datetime')
    renewed_at = Column('TEXT', dtype='datetime')


class SupervisorInstance(DBModel):
    __tablename__ = 'supervisor_instance'

    id = Column('INTEGER', primary_key=True)
    #: same identity string the lease's holder column uses
    holder = Column('TEXT', unique=True, nullable=False)
    computer = Column('TEXT')
    pid = Column('INTEGER')
    #: 'leader' | 'standby' (NOT named status/state: this is a
    #: monitoring mirror, not a guarded state machine — the lease row
    #: is the single source of truth for who leads)
    role = Column('TEXT')
    #: the epoch this instance last led at (0 = never led)
    epoch = Column('INTEGER', default=0)
    started = Column('TEXT', dtype='datetime')
    last_seen = Column('TEXT', dtype='datetime')


__all__ = ['SupervisorLease', 'SupervisorInstance']

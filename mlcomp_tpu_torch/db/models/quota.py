"""Multi-tenant scheduling models (migration v15) — fair-share quotas
and the checkpoint-preemption audit trail.

- ``quota``: one row per (scope, tenant, resource) limit — the
  admission ceiling the supervisor enforces before placement and the
  fair-share denominator it weighs same-class tasks by. ``scope`` says
  whether ``tenant`` names an owner or a project; ``resource`` is what
  the limit counts (live ``cores``, or windowed ``core_seconds`` read
  from the v14 usage ledger over ``window_s``). Absent row = unlimited
  (unknown tenants are not locked out); an explicit 0 = locked out.
- ``preemption``: one row per (victim task, attempt) eviction — WHO
  was evicted (victim + its priority class), WHY (the initiating task
  and reason), WHAT it cost (cores freed, computer), and the leader's
  **fencing epoch** at decision time. The row is recorded BEFORE the
  kill (conditional insert + unique index, the sweep_decision pattern)
  so the decision is exactly-once even under a raced double tick or a
  leader SIGKILLed mid-preemption: the standby's repair pass finds the
  recorded-but-unapplied row and finishes the kill instead of minting
  a second victim.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Quota(DBModel):
    __tablename__ = 'quota'

    id = Column('INTEGER', primary_key=True)
    scope = Column('TEXT', nullable=False, default='owner')  # owner|project
    tenant = Column('TEXT', nullable=False, index=True)
    resource = Column('TEXT', nullable=False,
                      default='cores')  # cores|core_seconds
    limit_value = Column('REAL', nullable=False, default=0.0)
    # accounting window for ledger-backed resources (core_seconds);
    # ignored for live-counted ones (cores)
    window_s = Column('REAL', default=86400.0)
    created = Column('TEXT', dtype='datetime')
    updated = Column('TEXT', dtype='datetime')


class Preemption(DBModel):
    __tablename__ = 'preemption'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)          # the victim
    attempt = Column('INTEGER', nullable=False, default=0)
    victim_class = Column('TEXT')          # victim's priority class
    gang_id = Column('TEXT')               # set for gang victims
    initiator = Column('INTEGER')          # blocked task that triggered it
    initiator_class = Column('TEXT')
    reason = Column('TEXT', default='capacity')  # capacity|defrag
    computer = Column('TEXT')              # where the cores came back
    cores_freed = Column('INTEGER', default=0)
    applied = Column('INTEGER', default=0, dtype='bool')
    epoch = Column('INTEGER')        # leader fencing epoch (0 = unfenced)
    time = Column('TEXT', dtype='datetime')


__all__ = ['Quota', 'Preemption']

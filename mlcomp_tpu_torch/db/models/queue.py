"""Queue message model — the DB-backed task transport.

Replaces the reference's Celery-over-Redis dispatch (reference
worker/app.py:10-17, worker/tasks.py:292-309). Capability preserved: named
per-(host, runtime) queues, revoke, result/status tracking — without an
external broker. Workers poll their queues; the supervisor enqueues.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class QueueMessage(DBModel):
    __tablename__ = 'queue_message'

    id = Column('INTEGER', primary_key=True)
    queue = Column('TEXT', nullable=False, index=True)
    payload = Column('TEXT', nullable=False)   # json {action, task_id, ...}
    # status reads ride the v11 composite indexes (status,queue,id) /
    # (status,claimed_at) — a single-column status index here would
    # re-pin sqlite's planner to the worse claim plan (migration v11)
    status = Column('TEXT', default='pending')
    # pending | claimed | done | failed | revoked
    created = Column('TEXT', dtype='datetime')
    # lease timestamp: stamped at claim AND at reclaim (where it times
    # the re-delivery window instead of the original lease)
    claimed_at = Column('TEXT', dtype='datetime')
    claimed_by = Column('TEXT')                # worker identity
    result = Column('TEXT')
    # lease reclaim happened once already (migration v7): the exactly-
    # once re-delivery guard — a twice-expired message fails instead
    redelivered = Column('INTEGER', default=0)

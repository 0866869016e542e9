"""Usage ledger model — one row per finished task attempt.

The cluster-economy measurement plane (the usage ledger, beside quotas
and checkpoint-preemption): who used the cluster (owner/project labels,
migration v14), how much (core-seconds =
assigned cores x started->finished wall clock), how long they waited
(queue_message enqueue->claim), and how hot they ran (peak HBM from the
``device*.hbm_used`` series when the task was instrumented). Rows are
folded by the supervisor at every terminal transition — exactly once
per (task, attempt), backstopped by a UNIQUE index the same way
sweep_decision guards its verdicts (migration v13) — so aggregation
queries (``UsageProvider.aggregate``) are plain GROUP BYs over settled
facts, never re-derivations from the live task table.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Usage(DBModel):
    __tablename__ = 'usage'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', index=True, nullable=False)
    # which incarnation of the task this row bills (task.attempt at
    # fold time): a retried task consumed real core-seconds on every
    # attempt, and the ledger must not merge them
    attempt = Column('INTEGER', default=0)
    dag = Column('INTEGER', index=True)
    owner = Column('TEXT', index=True)       # tenant label (v14)
    project = Column('TEXT', index=True)     # project NAME label (v14)
    task_class = Column('TEXT')  # train|sweep|serve-replica|service
    computer = Column('TEXT')
    cores = Column('INTEGER', default=0)     # cores billed (assigned)
    core_seconds = Column('REAL')            # cores x runtime
    queue_wait_s = Column('REAL')            # enqueue->claim, or NULL
    hbm_peak_bytes = Column('REAL')          # peak device HBM, or NULL
    started = Column('TEXT', dtype='datetime')
    finished = Column('TEXT', dtype='datetime')
    status = Column('INTEGER')               # terminal TaskStatus
    created = Column('TEXT', dtype='datetime')  # fold time


__all__ = ['Usage']

"""Sweep-scheduling models (migration v13) — the ASHA early-stopping
state the supervisor's sweep scheduler reads and the decision audit
trail it writes.

- ``sweep``: one row per swept grid executor — the policy knobs
  (metric/mode/eta/rung base/unit/min-cells guard) frozen at
  submission, plus the terminal summary (``best_task``/``best_score``
  once every cell is terminal). Cells are NOT listed here: a cell IS a
  task row of (``dag``, ``executor``) — the sweep rides the existing
  grid fan-out, it does not duplicate it.
- ``sweep_decision``: one row per (cell, rung) verdict — promote or
  prune, the score judged, the running top-``1/eta`` cutoff it was
  judged against, how many rung peers had reported, and the leader's
  **fencing epoch** at decision time. This is the audit trail the
  acceptance criteria require: every prune is attributable to a rung,
  a score, a cutoff and a leader incarnation, and the conditional
  insert (+ unique index) makes each verdict exactly-once even under
  a raced double tick or a leader failover mid-prune.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel

#: cell states the roster/metrics aggregate task rows into
SWEEP_CELL_STATES = ('waiting', 'queued', 'running', 'pruned',
                     'finished', 'failed')


class Sweep(DBModel):
    __tablename__ = 'sweep'

    id = Column('INTEGER', primary_key=True)
    dag = Column('INTEGER', foreign_key='dag.id', index=True,
                 nullable=False)
    executor = Column('TEXT', nullable=False)   # swept executor name
    name = Column('TEXT', nullable=False)       # display name
    metric = Column('TEXT', nullable=False)     # series cells report
    mode = Column('TEXT', default='max')        # max|min
    eta = Column('REAL', default=2.0)           # promote top 1/eta
    rung_base = Column('INTEGER', default=1)    # first rung boundary
    unit = Column('TEXT', default='epochs')     # epochs|steps
    min_cells_per_rung = Column('INTEGER', default=2)
    cells = Column('INTEGER', default=0)        # fan-out size at submit
    status = Column('TEXT', default='active')   # active|done
    best_task = Column('INTEGER')               # set once done
    best_score = Column('REAL')
    created = Column('TEXT', dtype='datetime')
    updated = Column('TEXT', dtype='datetime')


class SweepDecision(DBModel):
    __tablename__ = 'sweep_decision'

    id = Column('INTEGER', primary_key=True)
    sweep = Column('INTEGER', foreign_key='sweep.id', index=True,
                   nullable=False)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)
    rung = Column('INTEGER', nullable=False)
    verdict = Column('TEXT', nullable=False)    # promote|prune
    score = Column('REAL')
    cutoff = Column('REAL')          # top-1/eta quantile at judge time
    cells_seen = Column('INTEGER')   # rung peers reported at judge time
    epoch = Column('INTEGER')        # leader fencing epoch (0 = unfenced)
    time = Column('TEXT', dtype='datetime')


__all__ = ['Sweep', 'SweepDecision', 'SWEEP_CELL_STATES']

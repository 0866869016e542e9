"""Step model — hierarchical per-task step tree (parity: reference db/models/step.py:8-21)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Step(DBModel):
    __tablename__ = 'step'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)
    level = Column('INTEGER', default=1)
    started = Column('TEXT', dtype='datetime')
    finished = Column('TEXT', dtype='datetime')
    name = Column('TEXT')
    index = Column('INTEGER', default=0)

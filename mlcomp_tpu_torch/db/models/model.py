"""Model registry model (parity: reference db/models/model.py:8-24)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Model(DBModel):
    __tablename__ = 'model'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False)
    score_local = Column('REAL')
    score_public = Column('REAL')
    dag = Column('INTEGER', index=True)
    project = Column('INTEGER', foreign_key='project.id', index=True)
    created = Column('TEXT', dtype='datetime')
    equations = Column('TEXT')   # yaml: named serving-pipe expressions
    fold = Column('INTEGER')

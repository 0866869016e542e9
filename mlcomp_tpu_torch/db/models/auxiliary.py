"""Auxiliary model — key/value debug state (parity: reference db/models/auxilary.py:6-13)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Auxiliary(DBModel):
    __tablename__ = 'auxiliary'

    name = Column('TEXT', primary_key=True)
    data = Column('TEXT')   # json introspection blob

"""Log model (parity: reference db/models/log.py:7-22)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Log(DBModel):
    __tablename__ = 'log'

    id = Column('INTEGER', primary_key=True)
    step = Column('INTEGER', index=True)
    message = Column('TEXT')
    time = Column('TEXT', dtype='datetime')
    level = Column('INTEGER', default=1)       # LogStatus
    component = Column('INTEGER', default=0)   # ComponentType
    module = Column('TEXT')
    line = Column('INTEGER')
    task = Column('INTEGER', index=True)
    computer = Column('TEXT')

"""Computer models (parity: reference db/models/computer.py:8-36).

A Computer is a host in the cluster. The TPU-first resource vector is
(tpu cores, cpu, memory, disk); ``usage`` carries live telemetry JSON
including per-core TPU duty/HBM when available.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Computer(DBModel):
    __tablename__ = 'computer'

    name = Column('TEXT', primary_key=True)
    cores = Column('INTEGER', default=0)   # TPU cores on this host
    cpu = Column('INTEGER', default=1)
    memory = Column('REAL', default=0)     # GB
    usage = Column('TEXT')                 # live telemetry json
    ip = Column('TEXT', default='localhost')
    port = Column('INTEGER', default=22)
    user = Column('TEXT')
    disk = Column('REAL', default=0)       # GB
    syncing_computer = Column('TEXT')
    last_synced = Column('TEXT', dtype='datetime')
    can_process_tasks = Column('INTEGER', default=1, dtype='bool')
    sync_with_this_computer = Column('INTEGER', default=1, dtype='bool')
    usage_history_last = Column('TEXT', dtype='datetime')


class ComputerUsage(DBModel):
    __tablename__ = 'computer_usage'

    id = Column('INTEGER', primary_key=True)
    computer = Column('TEXT', index=True)
    usage = Column('TEXT')                 # aggregated telemetry json
    time = Column('TEXT', dtype='datetime')

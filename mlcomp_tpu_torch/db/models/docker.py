"""Docker (runtime environment) model (parity: reference db/models/docker.py:7-16).

A row is a live (computer, runtime image) pair: workers running inside that
runtime heartbeat ``last_activity``; the supervisor only dispatches to pairs
alive within the liveness window. ``ports`` carries the coordinator-port
range used for distributed training rendezvous (reference master-port range,
supervisor.py:163-169 — for JAX this feeds jax.distributed coordinator
addresses).
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Docker(DBModel):
    __tablename__ = 'docker'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False)
    computer = Column('TEXT', foreign_key='computer.name', index=True,
                      nullable=False)
    last_activity = Column('TEXT', dtype='datetime')
    ports = Column('TEXT')  # "start-end" coordinator port range

"""Dag model (parity: reference db/models/dag.py:9-24) + preflight
findings recorded against a dag."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Dag(DBModel):
    __tablename__ = 'dag'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False)
    created = Column('TEXT', dtype='datetime')
    config = Column('TEXT', nullable=False)   # full yaml config text
    project = Column('INTEGER', foreign_key='project.id', index=True)
    docker_img = Column('TEXT')               # runtime image/environment name
    img_size = Column('INTEGER', default=0)
    file_size = Column('INTEGER', default=0)
    type = Column('INTEGER', default=0)       # DagType
    report = Column('INTEGER')                # Report.id
    # tenant label (migration v14): who submitted this dag. The
    # usage ledger and queue accounting group by it; defaults to
    # 'default' when the config/CLI did not say.
    owner = Column('TEXT')
    # scheduling class (migration v15) stamped at submission; tasks
    # inherit it unless their executor spec overrides per-task
    priority = Column('TEXT')


class DagPreflight(DBModel):
    """One static-analysis finding stored against a dag
    (mlcomp_tpu_torch/analysis/). The submit gate stores warnings (errors
    reject the dag before any row exists); the supervisor stores the
    errors that made it refuse dispatch of a dag submitted through a
    path without the gate."""

    __tablename__ = 'dag_preflight'

    id = Column('INTEGER', primary_key=True)
    dag = Column('INTEGER', foreign_key='dag.id', index=True,
                 nullable=False)
    time = Column('TEXT', dtype='datetime')
    rule = Column('TEXT', nullable=False)     # findings.RULES id
    severity = Column('TEXT', nullable=False)  # error|warning
    path = Column('TEXT')                     # file or config path
    line = Column('INTEGER')
    message = Column('TEXT', nullable=False)
    source = Column('TEXT', default='submit')  # submit|supervisor|api

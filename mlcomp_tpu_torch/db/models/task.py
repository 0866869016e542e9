"""Task models (parity: reference db/models/task.py:9-63).

TPU-first resource model: a task requests ``cores``..``cores_max`` TPU
cores (the reference requested ``gpu``..``gpu_max`` GPU indices,
db/models/task.py:20-22); the scheduler assigns a concrete core list into
``cores_assigned``. The queue message id replaces the celery task id.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Task(DBModel):
    __tablename__ = 'task'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False)
    # TaskStatus; status reads ride the v11 composite
    # (status, next_retry_at) — its left prefix serves every
    # by_status scan, so no single-column twin (migration v11)
    status = Column('INTEGER', default=0)
    started = Column('TEXT', dtype='datetime')
    finished = Column('TEXT', dtype='datetime')
    computer = Column('TEXT')             # pinned computer name (or None)
    cores = Column('INTEGER', default=0)  # min TPU cores required
    cores_max = Column('INTEGER', default=0)
    cpu = Column('INTEGER', default=1)
    memory = Column('REAL', default=0.1)  # GB
    executor = Column('TEXT', nullable=False)
    computer_assigned = Column('TEXT', index=True)
    cores_assigned = Column('TEXT')       # json list of core indices
    docker_assigned = Column('TEXT')
    queue_id = Column('INTEGER')          # QueueMessage.id (was celery_id)
    pid = Column('INTEGER')
    worker_index = Column('INTEGER', default=-1)
    dag = Column('INTEGER', foreign_key='dag.id', index=True)
    parent = Column('INTEGER', index=True)  # service-task link to parent
    report = Column('INTEGER')
    score = Column('REAL')
    result = Column('TEXT')               # yaml result blob
    additional_info = Column('TEXT')      # yaml: distr_info, resume, grid_cell
    type = Column('INTEGER', default=0)   # TaskType
    current_step = Column('TEXT')         # dotted step path
    last_activity = Column('TEXT', dtype='datetime')
    debug = Column('INTEGER', default=0, dtype='bool')
    gpu_requirement = Column('TEXT')      # raw spec string e.g. "2-4"
    single_node = Column('INTEGER', default=1, dtype='bool')
    # automatic failure recovery (mlcomp_tpu_torch/recovery.py, migration v7):
    # retries consumed so far / per-task budget (None = policy default)
    attempt = Column('INTEGER', default=0)
    max_retries = Column('INTEGER')
    # when the supervisor may requeue a transiently-Failed task
    next_retry_at = Column('TEXT', dtype='datetime')
    failure_reason = Column('TEXT')       # taxonomy code, e.g. 'db-error'
    # gang-atomic multi-host recovery (migration v8): the gang a
    # fanned-out distributed job belongs to (parent AND service rows
    # share it) and which incarnation of it this row served. 0 = never
    # fanned out; the first dispatch is generation 1, each gang-atomic
    # requeue bumps it — the "did the whole gang come back exactly
    # once" accounting the chaos suite asserts on.
    gang_id = Column('TEXT', index=True)
    gang_generation = Column('INTEGER', default=0)
    # cluster-economy labels (migration v14): which tenant submitted
    # this work and which project NAME it bills to — denormalized onto
    # the task so the usage ledger folds and the queue-wait gauges
    # group without a dag/project join on the tick hot path.
    owner = Column('TEXT')
    project = Column('TEXT')
    # scheduling class (migration v15): critical|high|normal|
    # preemptible. NULL reads as the class-based default
    # (server/scheduler.py) so legacy rows keep their old ordering.
    priority = Column('TEXT')


class TaskDependence(DBModel):
    __tablename__ = 'task_dependence'

    id = Column('INTEGER', primary_key=True)
    task_id = Column('INTEGER', foreign_key='task.id', index=True,
                     nullable=False)
    depend_id = Column('INTEGER', foreign_key='task.id', index=True,
                       nullable=False)


class TaskSynced(DBModel):
    __tablename__ = 'task_synced'

    id = Column('INTEGER', primary_key=True)
    computer = Column('TEXT', nullable=False, index=True)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)

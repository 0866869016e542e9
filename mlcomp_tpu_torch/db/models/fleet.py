"""Serving-fleet models (migration v9) — the replica-pool state the
supervisor reconciles and the routing gateway reads.

The reference MLComp schedules every workload as a supervisor-managed
task; serving was the one tier still outside that loop (a single
``serve.py`` process). These two tables bring it inside:

- ``serve_fleet``: one row per served model — the DESIRED state
  (replica count, active export, SLO) plus the rolling-swap machine
  (``target_generation``/``target_model``/``swap_started``). The
  supervisor's fleet reconciler (server/fleet.py) drives ACTUAL toward
  it every tick.
- ``serve_replica``: one row per replica incarnation — which task row
  runs it, where it listens, its health-probe verdict, and the
  respawn lineage (``respawned_from``) that makes "killed and
  respawned on another computer exactly once" auditable.

A replica's LIFECYCLE rides the task machinery (lease reclaim,
watchdog, failure taxonomy); this table holds what the task row
cannot: the serving endpoint, the probe state the router keys on, and
the swap generation.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel

#: replica states the reconciler/gateway agree on
REPLICA_STATES = ('starting', 'healthy', 'unhealthy', 'draining', 'dead')


class ServeFleet(DBModel):
    __tablename__ = 'serve_fleet'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False, index=True)  # unique fleet name
    project = Column('TEXT')              # export-registry project
    model = Column('TEXT', nullable=False)  # export name/path being served
    desired = Column('INTEGER', default=2)  # replica count to reconcile to
    generation = Column('INTEGER', default=1)  # ACTIVE (routed) generation
    # rolling swap: generation N+1 warming up toward a router flip; NULL
    # when no swap is in flight
    target_generation = Column('INTEGER')
    target_model = Column('TEXT')
    swap_started = Column('TEXT', dtype='datetime')
    status = Column('TEXT', default='active')  # active|swapping|stopped
    # SLO-keyed admission control (gateway): shed with 429 once the
    # rolling p99 exceeds this
    slo_p99_ms = Column('REAL', default=250.0)
    max_pending = Column('INTEGER', default=256)  # per-fleet queue limit
    # replica-task resource ask + serving knobs (threaded into the
    # replica task / ModelServer)
    cores = Column('INTEGER', default=1)
    batch_size = Column('INTEGER', default=64)
    quantize = Column('TEXT')
    # scheduling class (migration v15) stamped onto every replica task
    # this fleet spawns; serving defaults to 'high' so scale-ups can
    # preempt preemptible batch work (server/scheduler.py)
    priority = Column('TEXT')
    created = Column('TEXT', dtype='datetime')
    updated = Column('TEXT', dtype='datetime')


class ServeReplica(DBModel):
    __tablename__ = 'serve_replica'

    id = Column('INTEGER', primary_key=True)
    fleet = Column('INTEGER', foreign_key='serve_fleet.id', index=True,
                   nullable=False)
    task = Column('INTEGER', foreign_key='task.id', index=True)
    generation = Column('INTEGER', default=1)
    state = Column('TEXT', default='starting', index=True)
    computer = Column('TEXT')
    port = Column('INTEGER')
    url = Column('TEXT')                  # http://host:port once bound
    probe_failures = Column('INTEGER', default=0)
    failure_reason = Column('TEXT')       # recovery-taxonomy verdict
    # the dead replica this one replaced (exactly-once respawn audit)
    respawned_from = Column('INTEGER')
    last_probe = Column('TEXT', dtype='datetime')
    last_ok = Column('TEXT', dtype='datetime')
    created = Column('TEXT', dtype='datetime')
    updated = Column('TEXT', dtype='datetime')


__all__ = ['ServeFleet', 'ServeReplica', 'REPLICA_STATES']

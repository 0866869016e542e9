"""Versioned schema migration + seed data (port of
``mlcomp_tpu/db/migration.py``, its sqlite dialect).

A ``migration_version`` table records the applied version; each of the
15 migrations is a python function applied in order, with the JAX
package's tables, indexes and seeded report layouts, so a DB migrated by
either package opens in the other as already current.
"""

from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.utils.misc import now

# --------------------------------------------------------------------------
# Seed report layouts. TPU-flavored: the base panel tracks step time,
# throughput (images/sec) and compile time instead of the reference's
# catalyst timer series (reference versions/002/report_layout/base.yml).
# --------------------------------------------------------------------------

LAYOUT_BASE = """\
metric:
  name: loss
  minimize: True

items:
  throughput:
    type: series
    key: throughput
  step_time:
    type: series
    key: step_time
  compile_time:
    type: series
    key: compile_time
  lr:
    type: series
    key: lr

layout:
  - type: panel
    title: base
    expanded: False
    parent_cols: 2
    row_height: 400
    items:
      - type: series
        source: throughput
      - type: series
        source: step_time
      - type: series
        source: compile_time
      - type: series
        source: lr
"""

LAYOUT_CLASSIFY = """\
extend: base

metric:
  name: accuracy
  minimize: False

items:
  loss:
    type: series
    key: loss
  accuracy:
    type: series
    key: accuracy

layout:
  - type: panel
    title: main
    parent_cols: 2
    row_height: 400
    items:
      - type: series
        source: loss
      - type: series
        source: accuracy
"""

LAYOUT_IMG_CLASSIFY = """\
extend: classify

items:
  img_classify:
    type: img_classify
    name: img_classify

layout:
  - type: panel
    title: images
    expanded: False
    items:
      - type: img_classify
        source: img_classify
"""

LAYOUT_SEGMENT = """\
extend: base

metric:
  name: dice
  minimize: False

items:
  loss:
    type: series
    key: loss
  dice:
    type: series
    key: dice
  iou:
    type: series
    key: iou
  img_segment:
    type: img_segment
    name: img_segment

layout:
  - type: panel
    title: main
    parent_cols: 2
    row_height: 400
    items:
      - type: series
        source: loss
      - type: series
        source: dice
      - type: series
        source: iou
  - type: panel
    title: images
    expanded: False
    items:
      - type: img_segment
        source: img_segment
"""

DEFAULT_LAYOUTS = {
    'base': LAYOUT_BASE,
    'classify': LAYOUT_CLASSIFY,
    'img_classify': LAYOUT_IMG_CLASSIFY,
    'segment': LAYOUT_SEGMENT,
}


def _v1_init(session: Session):
    """Create all tables + indices (reference versions/001_init.py)."""
    from mlcomp_tpu_torch.db.models import ALL_MODELS
    for model in ALL_MODELS:
        for stmt in model.create_table_ddl():
            session.execute(stmt)


def _v2_data(session: Session):
    """Seed default report layouts (reference versions/002_data.py:9-28)."""
    for name, content in DEFAULT_LAYOUTS.items():
        row = session.query_one(
            'SELECT id FROM report_layout WHERE name=?', (name,))
        if row is None:
            session.execute(
                'INSERT INTO report_layout (name, content, last_modified) '
                'VALUES (?, ?, ?)',
                (name, content, now()))


def _v3_auth(session: Session):
    """worker_token + db_audit tables (tiered /api/db credential)."""
    from mlcomp_tpu_torch.db.models import DbAudit, WorkerToken
    for model in (WorkerToken, DbAudit):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe


def _v4_telemetry(session: Session):
    """metric + telemetry_span tables (telemetry subsystem)."""
    from mlcomp_tpu_torch.db.models import Metric, TelemetrySpan
    for model in (Metric, TelemetrySpan):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe


def _v5_preflight(session: Session):
    """dag_preflight table (static-analysis subsystem, analysis/)."""
    from mlcomp_tpu_torch.db.models import DagPreflight
    for stmt in DagPreflight.create_table_ddl():
        session.execute(stmt)               # IF NOT EXISTS — safe


def _v6_tracing_alerts(session: Session):
    """trace_id/process_role columns on telemetry_span (cross-process
    trace propagation) + the alert table (watchdog findings). A fresh
    DB's _v1 already created telemetry_span with the new columns, so
    the ALTERs are guarded by a live pragma check."""
    have = session.table_columns('telemetry_span')
    for column in ('trace_id', 'process_role'):
        if column not in have:
            session.execute(
                f'ALTER TABLE telemetry_span ADD COLUMN "{column}" TEXT')
    session.execute(
        'CREATE INDEX IF NOT EXISTS idx_telemetry_span_trace_id '
        'ON telemetry_span("trace_id")')
    # composite (task, name): the watchdog reads small per-(task,name)
    # windows every evaluation — without this, each read sorts the
    # task's whole series
    session.execute(
        'CREATE INDEX IF NOT EXISTS idx_metric_task_name '
        'ON metric("task", "name")')
    from mlcomp_tpu_torch.db.models import Alert
    for stmt in Alert.create_table_ddl():
        session.execute(stmt)               # IF NOT EXISTS — safe


def _v7_recovery(session: Session):
    """Automatic failure recovery (mlcomp_tpu_torch/recovery.py): retry
    bookkeeping columns on task + the exactly-once re-delivery flag on
    queue_message. A fresh DB's _v1 already created both tables with
    the new columns, so the ALTERs are guarded by live pragma checks.
    DEFAULTs matter: legacy rows must read attempt=0/redelivered=0,
    not NULL, for the supervisor's arithmetic and the reclaim guard."""
    have = session.table_columns('task')
    if have:        # empty = table absent (partial legacy DB)
        for column, ddl in (
                ('attempt', '"attempt" INTEGER DEFAULT 0'),
                ('max_retries', '"max_retries" INTEGER'),
                ('next_retry_at', '"next_retry_at" TEXT'),
                ('failure_reason', '"failure_reason" TEXT')):
            if column not in have:
                session.execute(f'ALTER TABLE task ADD COLUMN {ddl}')
    have = session.table_columns('queue_message')
    if have and 'redelivered' not in have:
        session.execute(
            'ALTER TABLE queue_message ADD COLUMN '
            '"redelivered" INTEGER DEFAULT 0')


def _v8_gang(session: Session):
    """Gang-atomic multi-host recovery: gang identity + generation on
    task (stamped on the distributed parent and every fanned-out
    service row). A fresh DB's _v1 already created task with the new
    columns, so the ALTERs are guarded by a live pragma check. The
    gang_generation DEFAULT matters: legacy rows must read 0 ("never
    fanned out"), not NULL, for the supervisor's bump arithmetic."""
    have = session.table_columns('task')
    if have:        # empty = table absent (partial legacy DB)
        if 'gang_id' not in have:
            session.execute('ALTER TABLE task ADD COLUMN "gang_id" TEXT')
        if 'gang_generation' not in have:
            session.execute(
                'ALTER TABLE task ADD COLUMN '
                '"gang_generation" INTEGER DEFAULT 0')
        # the gang-stall watchdog rule and the `mlcomp_tpu_torch gangs` CLI
        # scan by gang id every evaluation — keep those reads indexed
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_task_gang_id '
            'ON task("gang_id")')


def _v9_fleet(session: Session):
    """Serving-fleet tables (server/fleet.py): serve_fleet (desired
    state + rolling-swap machine) and serve_replica (per-replica
    endpoint/health/lineage). New tables only — CREATE IF NOT EXISTS
    is safe on a fresh DB whose _v1 already made them."""
    from mlcomp_tpu_torch.db.models import ServeFleet, ServeReplica
    for model in (ServeFleet, ServeReplica):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe


def _v10_postmortem(session: Session):
    """OOM flight recorder: the ``postmortem`` table freezing a failed
    task's explanation bundle at death (telemetry/memory.py). New
    table only — CREATE IF NOT EXISTS is safe on a fresh DB whose _v1
    already made it."""
    from mlcomp_tpu_torch.db.models import Postmortem
    for stmt in Postmortem.create_table_ddl():
        session.execute(stmt)


def _v11_dispatch_indexes(session: Session):
    """Index audit for the queue/dispatch hot path (the load harness's
    findings, scripts/load_smoke.py). Three composite indexes:

    - ``queue_message(status, queue, id)`` — the claim candidate scan
      (``WHERE status='pending' AND queue IN (...) ORDER BY id``) and
      the supervisor's per-tick pending index. Without it every claim
      walks the per-queue index filtering status row by row; under
      thousands of done rows the pending head costs the whole history.
    - ``queue_message(status, claimed_at)`` — the lease reclaim and
      strand sweeps (``status='claimed' AND claimed_at < ?``), per
      tick, previously a status-index scan sorted by id.
    - ``task(status, next_retry_at)`` — the retry pass loads the
      transient-Failed set by status each tick; the composite keeps
      that read indexed as Failed history accumulates.

    The audit also DROPS the single-column status indexes both tables
    carried: every status read is a left prefix of its new composite
    (strictly at least as selective), keeping both would double the
    write amplification on the two hottest tables, and — concretely —
    sqlite's planner kept picking the narrower ``idx_*_status`` for
    the claim scan, pinning the hot path to the worse plan.

    tests/test_control_plane.py asserts the claim query stays on the
    composite via EXPLAIN, so a future schema change that silently
    deoptimizes the hot path fails CI. Guarded like every ALTER: a
    partial legacy DB without the table skips its indexes."""
    if session.table_columns('queue_message'):
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_queue_message_claim '
            'ON queue_message("status", "queue", "id")')
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_queue_message_lease '
            'ON queue_message("status", "claimed_at")')
        session.execute(
            'DROP INDEX IF EXISTS idx_queue_message_status')
    if session.table_columns('task'):
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_task_status_retry '
            'ON task("status", "next_retry_at")')
        session.execute('DROP INDEX IF EXISTS idx_task_status')


def _v12_supervisor_ha(session: Session):
    """Supervisor high availability: the ``supervisor_lease`` leader-
    election singleton (holder / fencing epoch / expiry) plus the
    ``supervisor_instance`` roster (db/models/supervisor.py). The
    lease row is SEEDED here (id=1, vacant, epoch 0) so acquisition is
    always one conditional UPDATE — never an INSERT race between two
    booting supervisors. CREATE IF NOT EXISTS is safe on a fresh DB
    whose _v1 already made the tables; the seed is guarded the same
    way."""
    from mlcomp_tpu_torch.db.models import SupervisorInstance, SupervisorLease
    for model in (SupervisorLease, SupervisorInstance):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe
    row = session.query_one(
        'SELECT id FROM supervisor_lease WHERE id=1')
    if row is None:
        session.execute(
            'INSERT INTO supervisor_lease (id, holder, epoch) '
            'VALUES (1, NULL, 0)')


def _v13_sweep(session: Session):
    """ASHA sweep scheduling (server/sweep.py): the ``sweep`` policy
    table and the ``sweep_decision`` audit trail recording every
    promote/prune verdict with its rung, score, cutoff and fencing
    epoch. CREATE IF NOT EXISTS is safe on a fresh DB whose _v1
    already made the tables; the UNIQUE index is the store-level
    backstop of the scheduler's exactly-once conditional insert (a
    raced double tick or a failover replay can never mint a second
    verdict for the same cell and rung)."""
    from mlcomp_tpu_torch.db.models import Sweep, SweepDecision
    for model in (Sweep, SweepDecision):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe
    session.execute(
        'CREATE UNIQUE INDEX IF NOT EXISTS idx_sweep_decision_once '
        'ON sweep_decision("sweep", "task", "rung")')


def _v14_usage(session: Session):
    """Cluster-economy accounting: owner/project tenant labels on
    dag/task plus the ``usage`` ledger table (db/models/usage.py). The
    ALTERs are guarded by live pragma checks like every column
    migration; the UNIQUE index is the store-level backstop of the
    supervisor fold's exactly-once conditional insert (a raced double
    tick or a failover replay can never double-bill an attempt — the
    sweep_decision pattern, v13). The backfill then folds every
    ALREADY-terminal task from its existing started/finished/
    cores_assigned columns so an upgraded deployment's /api/usage
    shows its history instead of a cold-start-empty ledger."""
    from mlcomp_tpu_torch.db.models import Usage
    have = session.table_columns('dag')
    if have and 'owner' not in have:
        session.execute('ALTER TABLE dag ADD COLUMN "owner" TEXT')
    have = session.table_columns('task')
    if have:        # empty = table absent (partial legacy DB)
        for column in ('owner', 'project'):
            if column not in have:
                session.execute(
                    f'ALTER TABLE task ADD COLUMN "{column}" TEXT')
    for stmt in Usage.create_table_ddl():
        session.execute(stmt)               # IF NOT EXISTS — safe
    session.execute(
        'CREATE UNIQUE INDEX IF NOT EXISTS idx_usage_once '
        'ON usage("task", "attempt")')
    # the per-tick queue_wait/starvation queries LEFT JOIN task on
    # queue_id — previously an unindexed column
    if session.table_columns('task'):
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_task_queue_id '
            'ON task("queue_id")')
    # the SLO engine's point lookups and window averages (WHERE name=?
    # AND time >= ?) and the export collectors' name-scans cannot be
    # served by the (task, name) index — name-first access needs its
    # own
    if session.table_columns('metric'):
        session.execute(
            'CREATE INDEX IF NOT EXISTS idx_metric_name_time '
            'ON metric("name", "time")')
    # backfill: one ledger row per already-terminal attempt. Metric
    # history may have aged out (hbm NULL) and old queue messages may be
    # gone (queue_wait NULL): the fold degrades per fact, it never skips
    # the row
    if session.table_columns('task'):
        from mlcomp_tpu_torch.db.providers.usage import UsageProvider
        provider = UsageProvider(session)
        while True:
            batch = provider.unfolded_terminal_tasks(limit=500)
            if not batch:
                break
            for task in batch:
                provider.fold_task(task)


def _v15_scheduling(session: Session):
    """Multi-tenant scheduling (server/scheduler.py): priority-class
    columns on dag/task/serve_fleet, the ``quota`` fair-share table
    and the ``preemption`` eviction audit trail (db/models/quota.py).
    The ALTERs are guarded by live pragma checks like every column
    migration; NULL priority deliberately stays NULL so legacy rows
    read their class-based default (sweep cells 'preemptible', serve
    replicas 'high', the rest 'normal') instead of freezing today's
    default into history. The UNIQUE index is the store-level backstop
    of the preemption engine's exactly-once conditional insert — a
    raced double tick or a failover replay can never evict the same
    attempt twice (the sweep_decision pattern, v13)."""
    from mlcomp_tpu_torch.db.models import Preemption, Quota
    for table in ('dag', 'task', 'serve_fleet'):
        have = session.table_columns(table)
        if have and 'priority' not in have:
            session.execute(
                f'ALTER TABLE {table} ADD COLUMN "priority" TEXT')
    for model in (Quota, Preemption):
        for stmt in model.create_table_ddl():
            session.execute(stmt)           # IF NOT EXISTS — safe
    session.execute(
        'CREATE UNIQUE INDEX IF NOT EXISTS idx_preemption_once '
        'ON preemption("task", "attempt")')
    session.execute(
        'CREATE UNIQUE INDEX IF NOT EXISTS idx_quota_key '
        'ON quota("scope", "tenant", "resource")')


MIGRATIONS = [_v1_init, _v2_data, _v3_auth, _v4_telemetry, _v5_preflight,
              _v6_tracing_alerts, _v7_recovery, _v8_gang, _v9_fleet,
              _v10_postmortem, _v11_dispatch_indexes, _v12_supervisor_ha,
              _v13_sweep, _v14_usage, _v15_scheduling]


def migrate(session: Session = None):
    """Apply pending migrations; returns the current version."""
    session = session or Session.create_session(key='migration')
    session.execute(
        'CREATE TABLE IF NOT EXISTS migration_version (version INTEGER)')
    row = session.query_one('SELECT MAX(version) AS v FROM migration_version')
    current = row['v'] if row and row['v'] is not None else 0
    for i, fn in enumerate(MIGRATIONS, start=1):
        if i > current:
            fn(session)
            session.execute(
                'INSERT INTO migration_version (version) VALUES (?)', (i,))
    return len(MIGRATIONS)


__all__ = ['migrate', 'DEFAULT_LAYOUTS']

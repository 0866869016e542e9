"""Telemetry models — metric series + tracing spans.

The reference persists per-epoch report series (db/models/report.py) and
per-computer usage samples; this build's telemetry subsystem
(mlcomp_tpu_torch/telemetry/) additionally records PER-STEP metric series and
tracing spans from inside the hot paths, buffered in memory and flushed
in batches. Two tables:

- ``metric``: one row per sample. ``task`` is nullable — supervisor
  tick timings and serving latency summaries belong to no task.
- ``telemetry_span``: one row per finished span. ``span_id``/
  ``parent_id`` are client-generated (process-scoped) so nesting survives
  batch insertion without a DB round trip per span. ``trace_id`` /
  ``process_role`` (migration v6) join spans ACROSS processes: one DAG
  submission's trace id rides the queue payload and the worker env, so
  supervisor/worker/train spans of the same task assemble into one
  cross-process tree (telemetry/spans.py trace context).

Plus ``alert``: one row per watchdog finding (telemetry/watchdog.py) —
a stalled task, a step-time regression, a straggler worker, HBM
pressure. Alerts are deduplicated per (rule, task) while open; the
supervisor re-touches rather than re-inserts on every tick.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Metric(DBModel):
    __tablename__ = 'metric'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', index=True)    # nullable: system metrics
    name = Column('TEXT', index=True, nullable=False)
    kind = Column('TEXT', default='series')  # series|counter|gauge|histogram
    step = Column('INTEGER')                # per-step series position
    value = Column('REAL')
    time = Column('TEXT', dtype='datetime')
    component = Column('TEXT')              # train|worker|supervisor|serving
    tags = Column('TEXT')                   # json dict or None


class TelemetrySpan(DBModel):
    __tablename__ = 'telemetry_span'

    id = Column('INTEGER', primary_key=True)
    span_id = Column('TEXT', index=True, nullable=False)
    parent_id = Column('TEXT')
    task = Column('INTEGER', index=True)    # nullable
    name = Column('TEXT', nullable=False)
    started = Column('REAL')                # epoch seconds (wall clock)
    duration = Column('REAL')               # seconds (monotonic diff)
    status = Column('TEXT', default='ok')   # ok|error
    tags = Column('TEXT')                   # json dict or None
    trace_id = Column('TEXT', index=True)   # cross-process trace (v6)
    process_role = Column('TEXT')           # supervisor|worker|train|...


class Postmortem(DBModel):
    """One frozen failure bundle per reasoned task failure (migration
    v10) — the OOM flight recorder's output (telemetry/memory.py).
    ``data`` is the assembled JSON bundle: the last N steps of the
    loss/phase/memory/compile series, the run snapshot (mesh, batch
    shape, model), the static memory attribution, the collective
    tally, and the task's alerts — captured at death so the
    explanation survives however much of the metric table later ages
    out. Retries append new rows; consumers read the newest."""

    __tablename__ = 'postmortem'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', index=True, nullable=False)
    created = Column('TEXT', dtype='datetime')
    reason = Column('TEXT')                 # taxonomy verdict at death
    data = Column('TEXT')                   # json bundle


class Alert(DBModel):
    __tablename__ = 'alert'

    id = Column('INTEGER', primary_key=True)
    time = Column('TEXT', dtype='datetime')
    rule = Column('TEXT', nullable=False, index=True)
    # task-stall | step-regression | straggler | hbm-pressure
    severity = Column('TEXT', default='warning')  # warning|critical
    task = Column('INTEGER', index=True)    # nullable: host-level alerts
    dag = Column('INTEGER')
    computer = Column('TEXT')
    message = Column('TEXT', nullable=False)
    details = Column('TEXT')                # json dict or None
    status = Column('TEXT', default='open', index=True)  # open|resolved
    resolved_time = Column('TEXT', dtype='datetime')


__all__ = ['Metric', 'TelemetrySpan', 'Alert', 'Postmortem']

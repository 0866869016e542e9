"""SLO burn-rate engine (port of ``mlcomp_tpu/telemetry/slo.py``):
declarative platform objectives evaluated from the supervisor tick,
alerting through the watchdog's alert path.

The watchdog (telemetry/watchdog.py) judges TASKS; this module judges
the PLATFORM: a small set of declarative objectives (dispatch p99,
queue-wait p95 per scheduling class, serving availability and p99 vs
``serve_fleet.slo_p99_ms``, step time vs each task's own rolling
baseline) evaluated on a rate-limited cadence inside the tick.

**Burn rates, not thresholds.** Each evaluation reduces an objective to
an instantaneous *bad fraction* in [0, 1] (binary for threshold
objectives, a real error rate for availability) and persists it as a
``slo.<key>.bad`` gauge row. Alerting then follows the multi-window
multi-burn-rate recipe (Google SRE workbook ch. 5): with an error
budget of ``1 - target``,

- **fast burn** — both the 5 m and the 1 h window burning at
  >= ``fast_burn`` x budget -> CRITICAL. The short window makes it
  fire within one evaluation of a hard failure; the long window keeps
  a single blip from paging.
- **slow burn** — the 6 h window burning at >= ``slow_burn`` x budget
  -> WARNING. Catches the creeping regression the fast pair ignores.

Windows are sample-averaged over the stored SLI series (the evaluation
cadence is constant, so this matches time-averaging), which also makes
the math unit-testable by seeding rows at chosen timestamps. Alerts
dedup per rule while open (AlertProvider: task IS NULL for these
platform rules) and AUTO-RESOLVE when every window is back under its
burn threshold.

Cost: a handful of indexed (name) AVG scans per objective per
evaluation, rate-limited to ``evaluate_every_s`` — off-cadence ticks
pay one clock read (the same contract as Watchdog.maybe_evaluate).
"""

import datetime
import statistics
import traceback

from mlcomp_tpu_torch.db.core import parse_datetime
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.providers import (
    AlertProvider, FleetProvider, MetricProvider, TaskProvider,
)
from mlcomp_tpu_torch.server.scheduler import (
    PRIORITY_CLASSES, TASK_CLASSES,
)
from mlcomp_tpu_torch.utils.misc import now

#: alert-rule prefix — every SLO alert is ``slo-<objective key>``
RULE_PREFIX = 'slo-'


class SloConfig:
    """Objectives + burn thresholds; construct with keyword overrides
    (``SloConfig(dispatch_p99_s=1.0)``)."""

    #: dispatch objective: flushed supervisor.dispatch_latency_s.p99
    #: must stay at or under this
    dispatch_p99_s = 5.0
    #: queue-wait objective: per-class queue.wait_s.<class>.p95 must
    #: stay at or under this
    queue_wait_p95_s = 600.0
    #: step-time objective: recent median over rolling baseline, per
    #: instrumented running task (the watchdog's regression factor)
    step_regression_factor = 2.0
    #: samples: baseline window (older) and recent window (newer)
    baseline_window = 20
    recent_window = 5
    #: serving availability target (error budget 1 - target)
    serving_availability_target = 0.999
    #: compliance target for binary (threshold) objectives
    compliance_target = 0.99
    #: burn-rate thresholds (SRE workbook defaults)
    fast_burn = 14.4
    slow_burn = 6.0
    #: window lengths (seconds): fast pair + slow
    fast_window_s = 300.0
    fast_long_window_s = 3600.0
    slow_window_s = 21600.0
    #: an input metric older than this is no evidence at all
    staleness_s = 900.0
    #: min seconds between evaluations (rate limit inside the tick)
    evaluate_every_s = 10.0

    def __init__(self, **overrides):
        for key, value in overrides.items():
            if not hasattr(type(self), key):
                raise TypeError(f'unknown SLO option {key!r}')
            setattr(self, key, float(value))


class SloEngine:
    """Evaluate the objectives against the DB; persist SLI rows +
    burn gauges; raise/resolve ``slo-*`` alerts. ``maybe_evaluate()``
    is the rate-limited entry the supervisor tick calls."""

    def __init__(self, session, config: SloConfig = None, logger=None):
        self.session = session
        self.config = config or SloConfig()
        self.logger = logger
        self._last_eval = None
        # per-fleet (requests_cum, shed_cum) watermark for the
        # availability delta — first sample after a (re)start is
        # baseline only, never a verdict
        self._fleet_seen = {}

    # ------------------------------------------------------------ plumbing
    def maybe_evaluate(self, now_dt=None):
        now_dt = now_dt or now()
        if self._last_eval is not None and \
                (now_dt - self._last_eval).total_seconds() < \
                self.config.evaluate_every_s:
            return []
        self._last_eval = now_dt
        return self.evaluate(now_dt=now_dt)

    def _latest(self, name, component=None, now_dt=None,
                within_s=None):
        """Newest value of a metric name, or None when absent or older
        than the staleness horizon."""
        sql = 'SELECT value, time FROM metric WHERE name=?'
        params = [name]
        if component is not None:
            sql += ' AND component=?'
            params.append(component)
        row = self.session.query_one(
            sql + ' ORDER BY id DESC LIMIT 1', tuple(params))
        if row is None or row['value'] is None:
            return None
        ts = parse_datetime(row['time'])
        horizon = within_s if within_s is not None \
            else self.config.staleness_s
        if ts is not None and now_dt is not None and \
                (now_dt - ts).total_seconds() > horizon:
            return None
        return float(row['value'])

    # ----------------------------------------------------------- measures
    def objectives(self, now_dt):
        """The declarative objective list for THIS evaluation:
        ``[(key, description, bad_fraction_or_None, budget,
        details)]``. Fleet objectives are enumerated from the live
        serve_fleet rows, so a new fleet is covered the tick after it
        activates with zero configuration."""
        cfg = self.config
        binary_budget = max(1e-9, 1.0 - cfg.compliance_target)
        out = []

        value = self._latest('supervisor.dispatch_latency_s.p99',
                             component='supervisor', now_dt=now_dt)
        out.append((
            'dispatch-p99',
            f'dispatch latency p99 <= {cfg.dispatch_p99_s:g}s',
            None if value is None
            else float(value > cfg.dispatch_p99_s),
            binary_budget,
            None if value is None else {'p99_s': round(value, 3)}))

        for cls in TASK_CLASSES:
            value = self._queue_wait_p95(cls, now_dt)
            out.append((
                f'queue-wait-{cls}',
                f'{cls} queue wait p95 <= {cfg.queue_wait_p95_s:g}s',
                None if value is None
                else float(value > cfg.queue_wait_p95_s),
                binary_budget,
                None if value is None else {'p95_s': round(value, 1)}))

        out += self._fleet_objectives(now_dt, binary_budget)
        out.append(self._step_time_objective())
        return out

    def _queue_wait_p95(self, cls, now_dt):
        """The class's queue-wait p95: ``queue.wait_s.<class>.p95`` where
        a tick wrote it, else the worst fresh p95 of the class's
        per-priority series ``queue.wait_s.<class>.<priority>.p95``,
        which is what the tick's recorder writes since waits carry their
        scheduling class (``record_tick_telemetry``). The port's tick
        never writes ``queue.wait_s.<class>.p95``: that read is there
        only so that rows seeded as the JAX package's tests seed them
        judge alike. The JAX engine reads the first name only, and so
        measures no queue-wait objective over a current tick's rows."""
        value = self._latest(f'queue.wait_s.{cls}.p95',
                             component='supervisor', now_dt=now_dt)
        if value is not None:
            return value
        found = [v for v in (
            self._latest(f'queue.wait_s.{cls}.{priority}.p95',
                         component='supervisor', now_dt=now_dt)
            for priority in PRIORITY_CLASSES) if v is not None]
        return max(found) if found else None

    def _fleet_objectives(self, now_dt, binary_budget):
        out = []
        try:
            fleets = FleetProvider(self.session).active()
        except Exception:
            return out
        avail_budget = max(
            1e-9, 1.0 - self.config.serving_availability_target)
        for fleet in fleets:
            name = fleet.name
            if fleet.slo_p99_ms:
                p99 = self._latest(f'fleet.{name}.latency_ms.p99',
                                   now_dt=now_dt)
                if p99 is None:
                    p99 = self._latest(f'serving.{name}.latency_ms.p99',
                                       now_dt=now_dt)
                out.append((
                    f'serving-p99-{name}',
                    f'fleet {name} p99 <= {fleet.slo_p99_ms:g}ms',
                    None if p99 is None
                    else float(p99 > float(fleet.slo_p99_ms)),
                    binary_budget,
                    None if p99 is None else {'p99_ms': round(p99, 2)}))
            # availability: shed fraction of the traffic since the
            # previous evaluation, from the gateway's cumulative
            # gauges (flush_telemetry)
            reqs = self._latest(f'fleet.{name}.requests_cum',
                                now_dt=now_dt)
            shed = self._latest(f'fleet.{name}.shed_cum',
                                now_dt=now_dt)
            bad, details = None, None
            if reqs is not None and shed is not None:
                prev = self._fleet_seen.get(name)
                self._fleet_seen[name] = (reqs, shed)
                if prev is not None and reqs > prev[0] and \
                        shed >= prev[1]:
                    d_req = reqs - prev[0]
                    d_shed = min(shed - prev[1], d_req)
                    bad = d_shed / d_req
                    details = {'requests': int(d_req),
                               'shed': int(d_shed)}
            out.append((
                f'serving-availability-{name}',
                f'fleet {name} availability >= '
                f'{self.config.serving_availability_target:.3%}',
                bad, avail_budget, details))
        return out

    def _step_time_objective(self):
        """Fraction of instrumented running tasks whose recent median
        step time exceeds ``step_regression_factor`` x their own
        rolling baseline — the platform-level view of the watchdog's
        per-task step-regression rule."""
        cfg = self.config
        key = 'step-time'
        desc = (f'step time <= {cfg.step_regression_factor:g}x '
                f'rolling baseline per task')
        try:
            running = TaskProvider(self.session).by_status(
                TaskStatus.InProgress)
            metrics = MetricProvider(self.session)
        except Exception:
            return key, desc, None, 1.0, None
        need = int(cfg.baseline_window + cfg.recent_window)
        judged = regressed = 0
        for task in running:
            values = metrics.recent_values(task.id, 'step_time_ms',
                                           limit=need)
            if len(values) < need:
                continue
            recent = statistics.median(
                values[:int(cfg.recent_window)])     # newest first
            baseline = statistics.median(
                values[int(cfg.recent_window):])
            if baseline <= 0:
                continue
            judged += 1
            if recent > cfg.step_regression_factor * baseline:
                regressed += 1
        budget = max(1e-9, 1.0 - cfg.compliance_target)
        if not judged:
            return key, desc, None, budget, None
        return (key, desc, regressed / judged, budget,
                {'judged': judged, 'regressed': regressed})

    # ----------------------------------------------------------- burn math
    def _window_avg(self, key, window_s, now_dt):
        """(avg bad fraction, sample count) of one SLI series over the
        trailing window — one indexed (name) scan."""
        cutoff = now_dt - datetime.timedelta(seconds=float(window_s))
        row = self.session.query_one(
            'SELECT AVG(value) AS avg, COUNT(*) AS n FROM metric '
            'WHERE name=? AND time >= ?',
            (f'slo.{key}.bad', cutoff))
        if row is None or not row['n']:
            return None, 0
        return float(row['avg']), int(row['n'])

    def burn_rates(self, key, budget, now_dt=None):
        """``{'fast': (burn, n), 'fast_long': ..., 'slow': ...}`` —
        window averages divided by the error budget; burn is None on
        an empty window."""
        now_dt = now_dt or now()
        out = {}
        for label, window_s in (
                ('fast', self.config.fast_window_s),
                ('fast_long', self.config.fast_long_window_s),
                ('slow', self.config.slow_window_s)):
            avg, n = self._window_avg(key, window_s, now_dt)
            out[label] = (None if avg is None else avg / budget, n)
        return out

    # ------------------------------------------------------------ evaluate
    def evaluate(self, now_dt=None):
        """One full pass: measure every objective, persist the SLI +
        burn gauge rows, raise/resolve the ``slo-*`` alerts. Returns
        finding dicts for the tick trace. A crashing objective is
        logged and skipped — it must not silence the others."""
        now_dt = now_dt or now()
        metrics = MetricProvider(self.session)
        alerts = AlertProvider(self.session)
        try:
            measured = self.objectives(now_dt)
        except Exception:
            if self.logger:
                self.logger.error(
                    f'slo measurement failed:\n{traceback.format_exc()}',
                    ComponentType.Supervisor)
            return []
        rows = [(None, f'slo.{key}.bad', 'gauge', None, float(bad),
                 now_dt, 'supervisor', None)
                for key, _, bad, _, _ in measured if bad is not None]
        if rows:
            metrics.add_many(rows)
        findings, burn_rows = [], []
        for key, desc, bad, budget, details in measured:
            try:
                finding = self._judge(key, desc, bad, budget, details,
                                      alerts, now_dt, burn_rows)
            except Exception:
                if self.logger:
                    self.logger.error(
                        f'slo objective {key} failed:\n'
                        f'{traceback.format_exc()}',
                        ComponentType.Supervisor)
                continue
            if finding is not None:
                findings.append(finding)
        if burn_rows:
            metrics.add_many(burn_rows)
        return findings

    def _judge(self, key, desc, bad, budget, details, alerts, now_dt,
               burn_rows):
        burns = self.burn_rates(key, budget, now_dt)
        fast, n_fast = burns['fast']
        fast_long, _ = burns['fast_long']
        slow, n_slow = burns['slow']
        for label, value in (('burn_fast', fast), ('burn_slow', slow)):
            if value is not None:
                burn_rows.append((None, f'slo.{key}.{label}', 'gauge',
                                  None, float(value), now_dt,
                                  'supervisor', None))
        if fast is None and slow is None:
            return None         # no evidence either way: keep silent
        rule = RULE_PREFIX + key
        payload = dict(details or {})
        payload.update({
            'objective': desc, 'budget': budget,
            'bad': None if bad is None else round(float(bad), 4),
            'burn_fast': None if fast is None else round(fast, 2),
            'burn_fast_long':
                None if fast_long is None else round(fast_long, 2),
            'burn_slow': None if slow is None else round(slow, 2)})
        cfg = self.config
        if fast is not None and fast >= cfg.fast_burn and \
                (fast_long is None or fast_long >= cfg.fast_burn):
            alert = alerts.raise_alert(
                rule,
                f'SLO {key} fast burn: {fast:.1f}x budget over '
                f'{cfg.fast_window_s / 60:.0f}m '
                f'(threshold {cfg.fast_burn:g}x) — {desc}',
                severity='critical', details=payload)
            return {'rule': rule, 'severity': 'critical',
                    'alert_id': alert.id, 'burn': round(fast, 2),
                    'message': alert.message}
        if slow is not None and slow >= cfg.slow_burn:
            alert = alerts.raise_alert(
                rule,
                f'SLO {key} slow burn: {slow:.1f}x budget over '
                f'{cfg.slow_window_s / 3600:.0f}h '
                f'(threshold {cfg.slow_burn:g}x) — {desc}',
                severity='warning', details=payload)
            return {'rule': rule, 'severity': 'warning',
                    'alert_id': alert.id, 'burn': round(slow, 2),
                    'message': alert.message}
        # healthy on every populated window: close the open alert
        if (n_fast or n_slow) and alerts.resolve_rule(rule):
            return {'rule': rule, 'severity': 'resolved',
                    'alert_id': None, 'burn': None,
                    'message': f'SLO {key} recovered'}
        return None


def slo_status(session, config: SloConfig = None):
    """Current state of every objective that has ever emitted an SLI
    sample — latest bad fraction, burn gauges, open alert — the shape
    ``/api/slos`` and the ``slos`` command serve. Pure read:
    no evaluation, no writes, safe from any process."""
    config = config or SloConfig()
    rows = session.query(
        "SELECT DISTINCT name FROM metric WHERE name LIKE 'slo.%.bad'")
    keys = sorted(r['name'][len('slo.'):-len('.bad')] for r in rows)
    open_alerts = {
        a.rule: a for a in AlertProvider(session).get(
            status='open', limit=1000)
        if a.rule.startswith(RULE_PREFIX)}
    out = []
    now_dt = now()
    engine = SloEngine(session, config=config)
    for key in keys:
        entry = {'key': key}
        for suffix, field in (('bad', 'bad'),
                              ('burn_fast', 'burn_fast'),
                              ('burn_slow', 'burn_slow')):
            value = engine._latest(f'slo.{key}.{suffix}',
                                   now_dt=now_dt,
                                   within_s=config.slow_window_s)
            entry[field] = value if value is None else round(value, 4)
        alert = open_alerts.get(RULE_PREFIX + key)
        entry['alert'] = AlertProvider.serialize(alert) \
            if alert is not None else None
        entry['status'] = alert.severity if alert is not None else 'ok'
        out.append(entry)
    return out


__all__ = ['SloEngine', 'SloConfig', 'slo_status', 'RULE_PREFIX']

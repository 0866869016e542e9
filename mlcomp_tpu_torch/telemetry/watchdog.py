"""Health watchdog: telemetry turned into actionable alerts (port of
``mlcomp_tpu/telemetry/watchdog.py``).

A small rule engine evaluated from the supervisor tick: it reads the
heartbeats, metric series and device stats already in the DB and
persists its findings as ``alert`` rows (``db/models/telemetry.py``).

Rules (all thresholds tunable through :class:`WatchdogConfig`):

- **task-stall** — an InProgress task whose newest evidence of life
  (``task.last_activity``, ``started``, or its newest metric sample) is
  older than ``stall_deadline_s``; life is pooled across a distributed
  family. Critical: the supervisor fails the task ``stall-killed`` and
  kills it (``SupervisorBuilder.run_watchdog``), so a hung run frees
  its card slot, and the retry pass resumes it from its checkpoint.
- **gang-stall** — a Queued/InProgress rank of a multi-host gang whose
  host's docker heartbeat is older than ``gang_host_silence_s``. The
  supervisor fails the rank ``worker-lost`` and aborts the gang.
- **step-regression** — a running task whose recent median
  ``step_time_ms`` exceeds ``regression_factor`` x its own rolling
  baseline (the older part of the same window).
- **straggler** — among the children of one distributed parent, a
  child whose recent median step time exceeds ``straggler_factor`` x
  the sibling median (at least ``straggler_min_children`` with data).
- **hbm-pressure** — a running task whose newest
  ``device<i>.hbm_used / hbm_limit`` occupancy crosses
  ``hbm_threshold``, or whose least-squares occupancy slope over the
  per-step timeline (``telemetry/memory.py`` ``MemorySampler``)
  projects the card's memory full within ``hbm_oom_horizon_steps``.
  On the port both figures are the CUDA caching allocator's
  (``telemetry/device.py``).
- **recompile-storm** — ``recompile_storm_count`` ``compile.backend_ms``
  events past ``recompile_warmup_steps`` within ``recompile_window_s``.
  On the port those rows are kernel builds and the first calls of a
  step's programs (``telemetry/compile_events.py``).
- **exposed-comm-regression** — the newest sampled device-time window's
  ``devtime.exposed_comm_frac`` rising more than
  ``devtime_exposed_rise`` over the task's own baseline
  (``telemetry/deviceprof.py``).

The ``straggler`` and ``gang-stall`` rules read rows of multi-host gangs
and ``exposed-comm-regression`` rows of a collective, which the port
writes only with A4 (ROADMAP.md); they judge whatever rows there are.

Cost: a handful of indexed SELECTs over the few InProgress tasks per
evaluation, and evaluations are rate-limited to ``evaluate_every_s``
inside the tick: an off-cadence tick pays one clock read. Alerts dedup
per (rule, task) while open (``AlertProvider.raise_alert``), and a rule
whose condition cleared resolves its open alert.
"""

import statistics
import traceback

from mlcomp_tpu_torch.db.core import parse_datetime
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.models import Task
from mlcomp_tpu_torch.db.providers import (
    AlertProvider, MetricProvider, TaskProvider,
)
from mlcomp_tpu_torch.utils.misc import now


class WatchdogConfig:
    """Thresholds; construct with keyword overrides
    (``WatchdogConfig(stall_deadline_s=60)``)."""

    #: seconds without heartbeat/metric progress before a task stalls.
    #: The deadline must exceed the longest LEGITIMATE quiet period —
    #: a ``run-task`` start, the first step's kernel builds and FLOP
    #: count, a checkpoint restore, a task running with telemetry
    #: disabled (whose only life signal is status-transition
    #: last_activity) — which is why the default is conservative. The
    #: metric-flush heartbeat (MetricRecorder.flush touches
    #: task.last_activity) keeps instrumented tasks far inside it.
    stall_deadline_s = 1800.0
    #: recent median step time must exceed factor x baseline median
    regression_factor = 2.0
    #: samples: baseline window (older) and recent window (newer)
    baseline_window = 20
    recent_window = 5
    #: child recent median vs sibling median
    straggler_factor = 1.5
    straggler_min_children = 3
    #: alert when HBM occupancy crosses this
    hbm_threshold = 0.92
    #: rising-trend alerts only above this floor
    hbm_trend_floor = 0.75
    #: samples of the occupancy window the OOM predictor regresses
    #: over (telemetry/memory.py's per-step timeline feeds it)
    hbm_predict_window = 8
    #: predicted steps-to-OOM at or under this horizon → critical
    #: BEFORE the crash. At the default sampler cadence (every step)
    #: this is minutes of warning on real step times — enough for an
    #: operator (or the scheduler) to act
    hbm_oom_horizon_steps = 500.0
    #: recompile storm: this many compile events past warmup inside
    #: the window → alert. Warmup compiles are FREE (every stage's
    #: first steps legitimately compile train/eval programs); the
    #: window is wall-clock so the alert auto-resolves once the storm
    #: stops even though the rows stay in the DB.
    recompile_storm_count = 3
    recompile_warmup_steps = 20
    recompile_window_s = 600.0
    #: exposed-comm regression: sampled devtime windows needed for a
    #: verdict (the newest window vs the median of the older ones in
    #: the same fetch)
    devtime_windows = 4
    #: the newest window's exposed-comm fraction must exceed the
    #: baseline median by this many fraction points (absolute — a
    #: quarter of the window flipping from hidden to exposed is a real
    #: regression at any model size) ...
    devtime_exposed_rise = 0.25
    #: ... and itself clear this noise floor (tiny fractions wobble
    #: window to window without meaning anything)
    devtime_exposed_floor = 0.05
    #: gang-stall: seconds of docker-heartbeat silence before a gang
    #: rank's host counts as preempted. Heartbeats tick every ~5 s, so
    #: this is dozens of missed beats — far past an agent restart or a
    #: 15 s liveness blip, far before the conservative per-task stall
    #: deadline (the gang's peers burn card time at a dead barrier for
    #: every second of it, which is why the horizon is its own knob)
    gang_host_silence_s = 180.0
    #: min seconds between evaluations (rate limit inside the tick)
    evaluate_every_s = 10.0

    def __init__(self, **overrides):
        for key, value in overrides.items():
            if not hasattr(type(self), key):
                raise TypeError(f'unknown watchdog option {key!r}')
            setattr(self, key, float(value))


class Watchdog:
    """Evaluate the rules against the DB; persist findings as alerts.

    ``evaluate()`` returns the list of findings raised THIS pass — the
    supervisor uses the task-stall entries to transition tasks out of
    the running state. ``maybe_evaluate()`` is the rate-limited entry
    the tick calls."""

    def __init__(self, session, config: WatchdogConfig = None,
                 logger=None):
        self.session = session
        self.config = config or WatchdogConfig()
        self.logger = logger
        self._last_eval = None

    # ------------------------------------------------------------ plumbing
    def _providers(self):
        return (TaskProvider(self.session), MetricProvider(self.session),
                AlertProvider(self.session))

    def maybe_evaluate(self, now_dt=None):
        """Rate-limited evaluate: a no-op (one clock read) until
        ``evaluate_every_s`` elapsed since the last pass."""
        now_dt = now_dt or now()
        if self._last_eval is not None and \
                (now_dt - self._last_eval).total_seconds() < \
                self.config.evaluate_every_s:
            return []
        self._last_eval = now_dt
        return self.evaluate(now_dt=now_dt)

    def evaluate(self, now_dt=None):
        """One full pass over every rule. Returns finding dicts:
        ``{'rule', 'task', 'message', 'severity', 'alert_id', ...}``.
        A crashing rule is logged and skipped — it must not silence
        the other rules."""
        now_dt = now_dt or now()
        tasks, metrics, alerts = self._providers()
        running = tasks.by_status(TaskStatus.InProgress)
        findings = []
        for rule in (
                lambda: self._check_stalls(running, metrics, alerts,
                                           now_dt),
                lambda: self._check_gang_stalls(alerts, now_dt),
                lambda: self._check_regressions(running, metrics,
                                                alerts),
                lambda: self._check_stragglers(running, metrics,
                                               alerts),
                lambda: self._check_hbm(running, metrics, alerts),
                lambda: self._check_recompiles(running, metrics,
                                               alerts, now_dt),
                lambda: self._check_exposed_comm(running, metrics,
                                                 alerts),
                lambda: self._sweep_finished(running, alerts)):
            try:
                findings += rule() or []
            except Exception:
                if self.logger:
                    self.logger.error(
                        f'watchdog rule failed:\n'
                        f'{traceback.format_exc()}',
                        ComponentType.Supervisor)
        return findings

    def _sweep_finished(self, running, alerts):
        """Auto-resolve condition alerts whose task is no longer
        running: regression/straggler/HBM alerts describe a LIVE
        condition, and the condition cannot outlive the task. Stall
        alerts stay open — they are the paper trail of a kill — and so
        do retry-exhausted alerts (supervisor recovery pass): both
        describe a task that is precisely NOT running anymore."""
        keep_open = ('task-stall', 'retry-exhausted', 'gang-stall')
        running_ids = {t.id for t in running}
        for alert in alerts.get(status='open', limit=1000):
            if alert.rule in keep_open or alert.task is None:
                continue
            if alert.task not in running_ids:
                alerts.resolve(alert.id)
        return []

    def _raise(self, alerts, rule, message, task, severity='warning',
               details=None):
        alert = alerts.raise_alert(
            rule, message, task=task.id, dag=task.dag,
            computer=task.computer_assigned, severity=severity,
            details=details)
        return {'rule': rule, 'task': task.id, 'message': message,
                'severity': severity, 'alert_id': alert.id,
                'details': details}

    # --------------------------------------------------------------- rules
    def _check_stalls(self, running, metrics, alerts, now_dt):
        newest = {}
        for task in running:
            latest = None
            for candidate in (task.last_activity, task.started,
                              metrics.last_sample_time(task.id)):
                candidate = parse_datetime(candidate)
                if candidate and (latest is None or candidate > latest):
                    latest = candidate
            newest[task.id] = latest
        # group pooling: only rank 0 of a distributed job writes
        # metric series (one writer per task), so a non-rank-0 service
        # child's own evidence goes quiet during healthy training, and
        # the PARENT row never executes at all — its clock freezes at
        # the InProgress transition. Any member's life counts for the
        # whole family (siblings AND the parent): the group stalls
        # together or not at all.
        group = {}
        for task in running:
            if task.parent and newest.get(task.id):
                prev = group.get(task.parent)
                if prev is None or newest[task.id] > prev:
                    group[task.parent] = newest[task.id]
        out = []
        for task in running:
            latest = newest.get(task.id)
            pooled = (group.get(task.parent) if task.parent else None,
                      group.get(task.id))   # children of THIS parent
            for candidate in pooled:
                if candidate and (latest is None or candidate > latest):
                    latest = candidate
            if latest is None:
                continue        # no clock evidence at all — can't judge
            age = (now_dt - latest).total_seconds()
            if age > self.config.stall_deadline_s:
                out.append(self._raise(
                    alerts, 'task-stall',
                    f'task {task.id} ({task.name}): no heartbeat or '
                    f'metric progress for {age:.0f}s '
                    f'(deadline {self.config.stall_deadline_s:.0f}s)',
                    task, severity='critical',
                    details={'age_s': round(age, 1)}))
        return out

    def _check_gang_stalls(self, alerts, now_dt):
        """One silent HOST aborts the gang: a live gang rank (Queued or
        InProgress — a never-claimed dispatch on a preempted host is
        exactly the stuck case) whose assigned computer's docker
        heartbeat is older than ``gang_host_silence_s``. Scans only
        rows with a gang id (indexed, v8) — zero cost on deployments
        without multi-host jobs."""
        deadline = float(self.config.gang_host_silence_s)
        rows = self.session.query(
            'SELECT * FROM task WHERE gang_id IS NOT NULL '
            'AND computer_assigned IS NOT NULL AND status IN (?, ?)',
            (int(TaskStatus.Queued), int(TaskStatus.InProgress)))
        ranks = [Task.from_row(r) for r in rows]
        if not ranks:
            return []
        heartbeats = {
            r['computer']: parse_datetime(r['hb'])
            for r in self.session.query(
                'SELECT computer, MAX(last_activity) AS hb FROM docker '
                'GROUP BY computer')}
        out = []
        for task in ranks:
            # the silence clock starts at the NEWEST of the host's
            # heartbeat and the rank's own activity (its dispatch
            # stamp): a host whose docker row predates this gang — or
            # is missing entirely — must not instantly abort a
            # just-placed generation
            latest = heartbeats.get(task.computer_assigned)
            own = parse_datetime(task.last_activity)
            if own and (latest is None or own > latest):
                latest = own
            if latest is None:
                continue
            age = (now_dt - latest).total_seconds()
            if age > deadline:
                out.append(self._raise(
                    alerts, 'gang-stall',
                    f'gang {task.gang_id} (generation '
                    f'{task.gang_generation}): rank task {task.id} '
                    f'({task.name}) on {task.computer_assigned} — host '
                    f'heartbeat silent for {age:.0f}s (deadline '
                    f'{deadline:.0f}s); aborting the gang',
                    task, severity='critical',
                    details={'age_s': round(age, 1),
                             'gang': task.gang_id,
                             'generation': task.gang_generation,
                             'parent': task.parent}))
        return out

    def _window(self, metrics, task_id, name='step_time_ms'):
        """(recent, baseline) medians of a task's step-time series, or
        None when the window is too shallow for a verdict."""
        need = int(self.config.baseline_window +
                   self.config.recent_window)
        values = metrics.recent_values(task_id, name, limit=need)
        if len(values) < need:
            return None
        recent = values[:int(self.config.recent_window)]   # newest first
        baseline = values[int(self.config.recent_window):]
        return (statistics.median(recent), statistics.median(baseline))

    def _check_regressions(self, running, metrics, alerts):
        out = []
        for task in running:
            window = self._window(metrics, task.id)
            if window is None:
                continue
            recent, baseline = window
            if baseline > 0 and \
                    recent > self.config.regression_factor * baseline:
                out.append(self._raise(
                    alerts, 'step-regression',
                    f'task {task.id} ({task.name}): recent step time '
                    f'{recent:.1f}ms is {recent / baseline:.1f}x its '
                    f'rolling baseline {baseline:.1f}ms',
                    task, details={'recent_ms': round(recent, 2),
                                   'baseline_ms': round(baseline, 2)}))
            elif baseline > 0:
                alerts.resolve_for_task(task.id, rule='step-regression')
        return out

    def _check_stragglers(self, running, metrics, alerts):
        out = []
        by_parent = {}
        for task in running:
            if task.parent:
                by_parent.setdefault(task.parent, []).append(task)
        for children in by_parent.values():
            recents = {}
            for child in children:
                values = metrics.recent_values(
                    child.id, 'step_time_ms',
                    limit=int(self.config.recent_window))
                if values:
                    recents[child.id] = statistics.median(values)
            if len(recents) < int(self.config.straggler_min_children):
                continue
            sibling_median = statistics.median(recents.values())
            if sibling_median <= 0:
                continue
            for child in children:
                mine = recents.get(child.id)
                if mine is None:
                    continue
                if mine > self.config.straggler_factor * sibling_median:
                    out.append(self._raise(
                        alerts, 'straggler',
                        f'task {child.id} ({child.name}) on '
                        f'{child.computer_assigned}: step time '
                        f'{mine:.1f}ms vs sibling median '
                        f'{sibling_median:.1f}ms '
                        f'({mine / sibling_median:.2f}x)',
                        child,
                        details={'mine_ms': round(mine, 2),
                                 'sibling_median_ms':
                                     round(sibling_median, 2)}))
                else:
                    alerts.resolve_for_task(child.id, rule='straggler')
        return out

    def _check_recompiles(self, running, metrics, alerts, now_dt):
        """Recompile storm: repeated builds AFTER warmup inside a
        wall-clock window (telemetry/compile_events.py records each as
        ``compile.backend_ms`` with its triggering step) — the
        signature of a shape-varying input rebuilding the step's
        programs every iteration. Time-windowed so the alert resolves
        on its own once the storm stops. The message keeps the JAX
        package's wording, which dashboards and alert routing match."""
        out = []
        warmup = int(self.config.recompile_warmup_steps)
        window = float(self.config.recompile_window_s)
        need = int(self.config.recompile_storm_count)
        for task in running:
            samples = metrics.recent_samples(
                task.id, 'compile.backend_ms', limit=max(need * 4, 32))
            if not samples:
                continue      # uninstrumented task — no verdict
            storm = []
            for step, value, ts in samples:
                if step is None or step <= warmup:
                    continue  # warmup compiles are expected
                ts = parse_datetime(ts)
                if ts is None or (now_dt - ts).total_seconds() > window:
                    continue
                storm.append((step, value))
            if len(storm) >= need:
                total_ms = sum(v for _, v in storm if v is not None)
                out.append(self._raise(
                    alerts, 'recompile-storm',
                    f'task {task.id} ({task.name}): {len(storm)} XLA '
                    f'recompiles after warmup within '
                    f'{window:.0f}s ({total_ms:.0f}ms spent '
                    f'compiling, last at step {storm[0][0]}) — likely '
                    f'a shape-varying input or weak-type flip '
                    f'retracing the step',
                    task,
                    details={'compiles': len(storm),
                             'compile_ms': round(total_ms, 1),
                             'last_step': storm[0][0]}))
            else:
                alerts.resolve_for_task(task.id, rule='recompile-storm')
        return out

    def _check_exposed_comm(self, running, metrics, alerts):
        """Exposed-comm regression: the newest sampled device-time
        window's ``devtime.exposed_comm_frac`` vs the task's own
        rolling baseline (median of the older windows in the same
        fetch). Per-task baseline for the same reason step-regression
        uses one — a comm-bound 70%-exposed model is not regressing,
        a compute-bound model jumping 10%→40% is. Warning severity:
        the run still makes progress, it just wastes the overlap."""
        need = int(self.config.devtime_windows)
        out = []
        for task in running:
            values = metrics.recent_values(
                task.id, 'devtime.exposed_comm_frac', limit=need)
            if len(values) < need:
                continue     # not enough sampled windows for a verdict
            newest = values[0]                        # newest first
            baseline = statistics.median(values[1:])
            rise = newest - baseline
            if newest > self.config.devtime_exposed_floor and \
                    rise > self.config.devtime_exposed_rise:
                out.append(self._raise(
                    alerts, 'exposed-comm-regression',
                    f'task {task.id} ({task.name}): exposed '
                    f'collective time jumped to {newest:.0%} of the '
                    f'sampled device-time window (rolling baseline '
                    f'{baseline:.0%}) — compute/comm overlap '
                    f'regressed; see the devtime series',
                    task,
                    details={'exposed_frac': round(newest, 4),
                             'baseline_frac': round(baseline, 4),
                             'rise': round(rise, 4)}))
            else:
                alerts.resolve_for_task(
                    task.id, rule='exposed-comm-regression')
        return out

    @staticmethod
    def _oom_prediction(points):
        """(slope_per_step, predicted_steps_to_oom) from a
        newest-first ``[(step, occupancy)]`` window via least squares
        — the trend half of the hbm-pressure rule. ``(None, None)``
        when the window is too shallow or the trend is flat/falling;
        prediction assumes the occupancy keeps climbing at the fitted
        slope until 1.0 (allocator slack above the limit is already
        gone by then)."""
        pts = [(s, o) for s, o in points if s is not None]
        if len(pts) < 4:
            # step-less legacy gauges: fall back to sample index so
            # per-epoch record_device_stats rows still get a verdict
            pts = [(i, o) for i, (_, o) in enumerate(reversed(points))]
            pts.reverse()
        if len(pts) < 4:
            return None, None
        n = len(pts)
        mean_s = sum(s for s, _ in pts) / n
        mean_o = sum(o for _, o in pts) / n
        var = sum((s - mean_s) ** 2 for s, _ in pts)
        if var <= 0:
            return None, None
        slope = sum((s - mean_s) * (o - mean_o) for s, o in pts) / var
        if slope <= 0:
            return slope, None
        headroom = 1.0 - pts[0][1]           # newest occupancy
        if headroom <= 0:
            return slope, 0.0
        return slope, headroom / slope

    def _check_hbm(self, running, metrics, alerts):
        """HBM pressure, two ways: the fixed occupancy threshold, and
        trend-based OOM prediction — a least-squares slope over the
        recent per-step timeline (telemetry/memory.py MemorySampler)
        projecting when occupancy hits 1.0. A projection inside
        ``hbm_oom_horizon_steps`` is CRITICAL while the run is still
        alive — the point of a flight recorder is the alert BEFORE the
        crash, not the bundle after it."""
        window = int(self.config.hbm_predict_window)
        out = []
        for task in running:
            names = metrics.names(task.id, like='device%.hbm_used')
            worst = None    # ((step, occ) history newest-first, dev)
            for used_name in names:
                limit_name = used_name.replace('.hbm_used', '.hbm_limit')
                used = metrics.recent_step_values(task.id, used_name,
                                                  limit=window)
                limits = dict(metrics.recent_step_values(
                    task.id, limit_name, limit=window))
                # join on STEP: the two windows are fetched
                # independently and one side may have dropped a sample
                occ = [(step, value / limits[step])
                       for step, value in used if limits.get(step)]
                if occ and (worst is None or occ[0][1] > worst[0][0][1]):
                    worst = (occ, used_name)
            if worst is None:
                continue
            occ, dev = worst
            now_occ = occ[0][1]
            values = [o for _, o in occ]
            rising = len(values) >= 4 and all(
                a > b for a, b in zip(values, values[1:]))  # newest 1st
            slope, predicted = self._oom_prediction(occ)
            imminent = (
                predicted is not None
                and predicted <= float(self.config.hbm_oom_horizon_steps)
                and now_occ > self.config.hbm_trend_floor)
            if now_occ > self.config.hbm_threshold or imminent or \
                    (rising and now_occ > self.config.hbm_trend_floor):
                message = (f'task {task.id} ({task.name}): HBM '
                           f'occupancy {now_occ:.0%} on '
                           f'{dev.split(".")[0]}')
                if imminent:
                    message += (f' — projected OOM in '
                                f'~{predicted:.0f} steps at the '
                                f'current growth rate')
                elif rising:
                    message += ' and rising'
                message += \
                    f' (threshold {self.config.hbm_threshold:.0%})'
                critical = now_occ > self.config.hbm_threshold \
                    or imminent
                details = {'occupancy': round(now_occ, 4),
                           'rising': rising}
                if slope is not None:
                    details['slope_per_step'] = round(slope, 6)
                if predicted is not None:
                    details['predicted_steps_to_oom'] = \
                        round(predicted, 1)
                out.append(self._raise(
                    alerts, 'hbm-pressure', message, task,
                    severity='critical' if critical else 'warning',
                    details=details))
            else:
                alerts.resolve_for_task(task.id, rule='hbm-pressure')
        return out


__all__ = ['Watchdog', 'WatchdogConfig']

"""The port's watchdog, SLO engine and tick telemetry against the JAX
package's, on twin sqlite DBs (``tests/test_torch_port_supervisor.py``'s
``Twin``): the same rows go into both files, each package's module runs
on its own copy with the same ``now_dt``, and the findings, the
``alert`` rows (their times aside) and the ``slo.*``, ``supervisor.*``,
``queue.*`` and ``db.*`` metric rows must be equal.

- **Rules**: every case of ``tests/test_watchdog.py`` (stall with the
  family's pooled evidence, dedup and the rate limit, step regression,
  straggler, HBM pressure with the OOM projection, recompile storm from
  seeded ``compile.backend_ms`` rows, exposed comm) and the gang-stall
  rule; ``_oom_prediction`` under hypothesis; a flush of the port's
  ``MetricRecorder`` counts as life.
- **SLOs**: the burn-rate cases of ``tests/test_usage_slo.py``, the
  queue-wait, fleet (with the availability watermark) and step-time
  objectives, ``slo_status``.
- **The tick**: ``record_tick_telemetry`` and the starvation gauges, each
  recorder call of the tick in the scenario that makes it, containment
  of a crashing watchdog or SLO engine, ``FenceLostError`` under a zombie
  lease, the reclaim horizon following ``stall_deadline_s``, the
  gang-stall action.
- **The kill**: ``run-task`` processes stall-killed and retried (a
  trainer hung at the ``train.epoch`` seam resumes after its checkpoint;
  a process that exits only after the requeue leaves the next attempt
  alone); a beating ``serve_replica`` is never stall-killed.
- **Routes, commands, metrics**: ``/api/slos`` and its GET mirror,
  ``alerts`` and ``slos`` printing JAX's text, the ``/metrics`` families
  these rows feed.
"""

import datetime
import json
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import mlcomp_tpu.db.core as jax_core
import mlcomp_tpu.db.events as jax_events
import mlcomp_tpu.db.fencing as jax_fencing
from mlcomp_tpu.db.enums import TaskStatus as JaxStatus
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu.telemetry import MetricRecorder as JaxRecorder
from mlcomp_tpu.telemetry import SloConfig as JaxSloConfig
from mlcomp_tpu.telemetry import SloEngine as JaxSloEngine
from mlcomp_tpu.telemetry import Watchdog as JaxWatchdog
from mlcomp_tpu.telemetry import WatchdogConfig as JaxWatchdogConfig
from mlcomp_tpu.telemetry import slo_status as jax_slo_status
from mlcomp_tpu.utils.misc import now
import mlcomp_tpu_torch.server.supervisor as port_supervisor
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.providers import (
    AlertProvider, DockerProvider, TaskProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server.supervisor import SupervisorBuilder
from mlcomp_tpu_torch.telemetry import (
    MetricRecorder, SloConfig, SloEngine, Watchdog, WatchdogConfig,
    slo_status,
)

from tests.test_torch_port_supervisor import TickSeconds, Twin, _ago


def _alerts(session) -> list:
    return [{k: v for k, v in dict(r).items()
             if k not in ('time', 'resolved_time')}
            for r in session.query('SELECT * FROM alert ORDER BY id')]


class Pair(Twin):
    """Twin DBs for the rule and objective cases: rows written with SQL
    into both files at times relative to one clock ``t0``, so the two
    packages see the same rows and judge them at the same ``now_dt``."""

    def __init__(self, tmp_path):
        super().__init__(tmp_path)
        self.start()
        self.t0 = now()
        self.watchdogs = None
        self.engines = None

    def at(self, seconds=0.0):
        return self.t0 + datetime.timedelta(seconds=seconds)

    def add_task(self, name='t', status=JaxStatus.InProgress, age_s=0.0,
                 parent=None, computer=None, **cols) -> int:
        stamp = self.at(-age_s)
        cols = {'name': name, 'executor': 'e', 'dag': self.dag,
                'status': int(status), 'parent': parent,
                'computer_assigned': computer, 'started': stamp,
                'last_activity': stamp, **cols}
        self.both(f'INSERT INTO task ({", ".join(cols)}) VALUES '
                  f'({", ".join("?" * len(cols))})', tuple(cols.values()))
        return self.port.query_one('SELECT MAX(id) AS id FROM task')['id']

    def series(self, task, name, values, start_step=0, age_s=0.0,
               component='train', steps=True):
        for i, v in enumerate(values):
            self.both('INSERT INTO metric (task, name, kind, step, value, '
                      'time, component, tags) VALUES (?, ?, ?, ?, ?, ?, ?, '
                      'NULL)', (task, name, 'series',
                                start_step + i if steps else None,
                                float(v), self.at(-age_s), component))

    # ------------------------------------------------------- the watchdog
    def watch(self, **overrides):
        """Both packages' watchdogs with the test config's overrides."""
        base = dict(evaluate_every_s=0.0, baseline_window=4,
                    recent_window=2, stall_deadline_s=3600)
        base.update(overrides)
        self.watchdogs = (
            JaxWatchdog(self.jax, JaxWatchdogConfig(**base)),
            Watchdog(self.port, WatchdogConfig(**base)))
        return self

    def evaluate(self, at=0.0, maybe=False, rule=None):
        """One pass of each watchdog at ``t0 + at``: the findings and the
        alert rows equal; the port's findings (of ``rule``) returned."""
        if self.watchdogs is None:
            self.watch()
        out = []
        for wd in self.watchdogs:
            fn = wd.maybe_evaluate if maybe else wd.evaluate
            out.append(fn(now_dt=self.at(at)))
        theirs, mine = out
        assert mine == theirs
        assert _alerts(self.port) == _alerts(self.jax)
        return [f for f in mine if rule is None or f['rule'] == rule]

    # ------------------------------------------------------ the SLO engine
    def slo(self, **overrides):
        self.engines = (JaxSloEngine(self.jax, JaxSloConfig(**overrides)),
                        SloEngine(self.port, SloConfig(**overrides)))
        return self

    def judge(self, at=0.0, maybe=False):
        """One pass of each engine at ``t0 + at``: the findings, the
        ``slo.*`` rows and the alert rows equal; the port's findings."""
        if self.engines is None:
            self.slo()
        out = []
        for engine in self.engines:
            fn = engine.maybe_evaluate if maybe else engine.evaluate
            out.append(fn(now_dt=self.at(at)))
        theirs, mine = out
        assert mine == theirs
        assert _slo_rows(self.port) == _slo_rows(self.jax)
        assert _alerts(self.port) == _alerts(self.jax)
        return mine

    def sli(self, key, points):
        """``slo.<key>.bad`` rows: ``points`` = [(age_s, value)]."""
        for age, value in points:
            self.both('INSERT INTO metric (task, name, kind, step, value, '
                      'time, component, tags) VALUES (NULL, ?, ?, NULL, ?, '
                      "?, 'supervisor', NULL)",
                      (f'slo.{key}.bad', 'gauge', float(value),
                       self.at(-age)))


def _slo_rows(session) -> list:
    return [tuple(r) for r in session.query(
        "SELECT name, kind, step, value, time, component, tags FROM metric "
        "WHERE name LIKE 'slo.%' ORDER BY id")]


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


# ----------------------------------------------------------------- rules
def _stall(p):
    task = p.add_task(age_s=120)
    (f,) = p.watch(stall_deadline_s=30).evaluate()
    assert (f['rule'], f['task'], f['severity']) == (
        'task-stall', task, 'critical')
    assert f['details'] == {'age_s': 120.0}


def _live_heartbeat(p):
    p.add_task(age_s=0)
    assert p.watch(stall_deadline_s=30).evaluate() == []


def _fresh_sample_is_life(p):
    task = p.add_task(age_s=120)
    p.series(task, 'loss', [0.5])
    assert p.watch(stall_deadline_s=30).evaluate() == []


def _siblings_pool(p):
    parent = p.add_task('parent', status=JaxStatus.Queued)
    quiet = p.add_task('rank1', parent=parent, age_s=600)
    rank0 = p.add_task('rank0', parent=parent, age_s=600)
    p.series(rank0, 'loss', [0.5])
    assert p.watch(stall_deadline_s=60).evaluate(rule='task-stall') == []
    p.both('DELETE FROM metric WHERE task=?', (rank0,))
    assert {f['task'] for f in p.evaluate(rule='task-stall')} == {
        quiet, rank0}


def _children_pool_into_parent(p):
    parent = p.add_task('parent', age_s=600)
    child = p.add_task('rank0', parent=parent, age_s=600)
    p.series(child, 'loss', [0.5])
    assert p.watch(stall_deadline_s=60).evaluate(rule='task-stall') == []


def _dedup(p):
    p.add_task(age_s=120)
    p.watch(stall_deadline_s=30).evaluate()
    p.evaluate(at=5)
    assert len(_alerts(p.port)) == 1


def _rate_limit(p):
    p.add_task(age_s=120)
    p.watch(stall_deadline_s=30, evaluate_every_s=3600)
    assert len(p.evaluate(maybe=True)) == 1
    assert p.evaluate(at=60, maybe=True) == []


def _regression(p):
    task = p.add_task()
    p.series(task, 'step_time_ms', [100, 100, 100, 100, 300, 310])
    (f,) = p.evaluate()
    assert f['rule'] == 'step-regression'
    assert f['details'] == {'recent_ms': 305.0, 'baseline_ms': 100.0}


def _steady(p):
    task = p.add_task()
    p.series(task, 'step_time_ms', [100] * 6)
    assert p.evaluate() == []


def _shallow_step_window(p):
    task = p.add_task()
    p.series(task, 'step_time_ms', [100, 900])
    assert p.evaluate() == []


def _finished_sweep_keeps_stall_alerts(p):
    task = p.add_task()
    stalled = p.add_task('dead', status=JaxStatus.Failed)
    for session in (p.jax, p.port):
        provider = AlertProvider(session)
        provider.raise_alert('step-regression', 'slow', task=task)
        provider.raise_alert('task-stall', 'stuck', task=stalled)
    p.both('UPDATE task SET status=? WHERE id=?',
           (int(JaxStatus.Success), task))
    p.evaluate()
    assert [(a['rule'], a['status']) for a in _alerts(p.port)] == [
        ('step-regression', 'resolved'), ('task-stall', 'open')]


def _regression_recovers(p):
    task = p.add_task()
    p.series(task, 'step_time_ms', [100, 100, 100, 100, 300, 310])
    assert p.evaluate()
    p.series(task, 'step_time_ms', [100] * 6, start_step=6)
    assert p.evaluate() == []
    assert [a['status'] for a in _alerts(p.port)] == ['resolved']


def _straggler(p):
    parent = p.add_task('parent', status=JaxStatus.Queued)
    children = {}
    for name, ms in (('c0', 100), ('c1', 105), ('c2', 300)):
        children[name] = p.add_task(name, parent=parent,
                                    computer=f'host_{name}')
        p.series(children[name], 'step_time_ms', [ms] * 3)
    (f,) = p.evaluate(rule='straggler')
    assert f['task'] == children['c2'] and 'host_c2' in f['message']


def _two_children_are_not_enough(p):
    parent = p.add_task('parent', status=JaxStatus.Queued)
    for name, ms in (('c0', 100), ('c1', 400)):
        p.series(p.add_task(name, parent=parent), 'step_time_ms', [ms] * 3)
    assert p.evaluate(rule='straggler') == []


def _hbm(used, limit, rule_args=None, steps=True):
    def case(p):
        task = p.add_task()
        p.series(task, 'device0.hbm_used', used, steps=steps)
        p.series(task, 'device0.hbm_limit', limit, steps=steps)
        p.watch(**(rule_args or {}))
        return p.evaluate(rule='hbm-pressure')
    return case


def _hbm_over_threshold(p):
    (f,) = _hbm([9.5e9], [1e10])(p)
    assert f['severity'] == 'critical'
    assert f['details']['occupancy'] == pytest.approx(0.95)


def _hbm_steep_rise(p):
    (f,) = _hbm([7.6e9, 7.8e9, 8.0e9, 8.2e9], [1e10] * 4)(p)
    assert f['severity'] == 'critical' and f['details']['rising'] is True
    assert f['details']['predicted_steps_to_oom'] == pytest.approx(9.0,
                                                                   abs=0.2)
    assert 'projected OOM' in f['message']


def _hbm_shallow_rise(p):
    (f,) = _hbm([7.600e9, 7.601e9, 7.602e9, 7.603e9], [1e10] * 4,
                {'hbm_oom_horizon_steps': 100})(p)
    assert f['severity'] == 'warning'
    assert f['details']['predicted_steps_to_oom'] > 100


def _hbm_noisy_rise(p):
    used = [8.8e9, 8.6e9, 8.65e9, 8.5e9, 8.4e9, 8.3e9]
    (f,) = _hbm(list(reversed(used)), [1e10] * 6)(p)
    assert f['severity'] == 'critical' and f['details']['rising'] is False
    assert 5 < f['details']['predicted_steps_to_oom'] < 20


def _hbm_falling(p):
    assert _hbm([8.9e9, 8.7e9, 8.5e9, 8.3e9], [1e10] * 4)(p) == []


def _hbm_flat_low(p):
    assert _hbm([5e9] * 4, [1e10] * 4)(p) == []


def _hbm_stepless_gauges(p):
    """Per-epoch gauges without steps: the projection falls back to the
    sample index (JAX's legacy path)."""
    (f,) = _hbm([7.6e9, 7.8e9, 8.0e9, 8.2e9], [1e10] * 4, steps=False)(p)
    assert f['details']['rising'] is True
    assert f['details']['predicted_steps_to_oom'] == pytest.approx(9.0,
                                                                   abs=0.2)


def _storm(p, steps, age_s=0.0):
    task = p.add_task()
    for s in steps:
        p.both("INSERT INTO metric (task, name, kind, step, value, time, "
               "component, tags) VALUES (?, 'compile.backend_ms', 'series', "
               "?, 120.0, ?, 'train', NULL)", (task, s, p.at(-age_s)))
    return task


def _recompile_storm(p):
    task = _storm(p, [50, 51, 52, 53])
    (f,) = p.evaluate(rule='recompile-storm')
    assert f['task'] == task and f['details'] == {
        'compiles': 4, 'compile_ms': 480.0, 'last_step': 53}
    p.evaluate(at=5)
    assert len(_alerts(p.port)) == 1
    assert p.evaluate(at=600 + 60, rule='recompile-storm') == []
    assert [a['status'] for a in _alerts(p.port)] == ['resolved']


def _warmup_builds_are_free(p):
    _storm(p, [1, 3, 5, 8])
    assert p.evaluate(rule='recompile-storm') == []


def _below_storm_count(p):
    _storm(p, [30, 45])
    assert p.evaluate(rule='recompile-storm') == []


def _old_storm(p):
    _storm(p, [30, 31, 32, 33], age_s=3600)
    assert p.watch(stall_deadline_s=7200).evaluate(
        rule='recompile-storm') == []


def _storm_threshold_override(p):
    _storm(p, [30, 45])
    assert len(p.watch(recompile_storm_count=2).evaluate(
        rule='recompile-storm')) == 1


def _exposed(values, **overrides):
    def case(p):
        task = p.add_task()
        p.series(task, 'devtime.exposed_comm_frac', values)
        p.watch(**overrides)
        return task, p.evaluate(rule='exposed-comm-regression')
    return case


def _exposed_comm(p):
    task, (f,) = _exposed([0.10, 0.11, 0.09, 0.45])(p)
    assert f['severity'] == 'warning'
    assert f['details']['exposed_frac'] == pytest.approx(0.45)
    p.series(task, 'devtime.exposed_comm_frac', [0.10, 0.11, 0.10, 0.09],
             start_step=4)
    assert p.evaluate(rule='exposed-comm-regression') == []
    assert [a['status'] for a in _alerts(p.port)] == ['resolved']


def _comm_bound_baseline(p):
    assert _exposed([0.70, 0.72, 0.69, 0.71])(p)[1] == []


def _shallow_devtime(p):
    assert _exposed([0.05, 0.60])(p)[1] == []


def _sub_floor_wobble(p):
    assert _exposed([0.0, 0.001, 0.0, 0.04],
                    devtime_exposed_rise=0.01)(p)[1] == []


def _gang_stall(p):
    """Two ranks of gang g1 on h1 (heartbeating) and h2 (silent 400 s);
    a Queued rank on h3 whose host row predates the gang but whose own
    dispatch stamp is fresh; a rank on h4 with no docker row at all."""
    parent = p.add_task('gang', gang_id='g1', gang_generation=2)
    for host, age in (('h1', 1), ('h2', 400), ('h3', 900)):
        p.both('INSERT INTO computer (name, cores, cpu, memory, ip, '
               "can_process_tasks) VALUES (?, 1, 1, 1.0, '127.0.0.1', 1)",
               (host,))
        p.both('INSERT INTO docker (computer, name, last_activity) '
               "VALUES (?, 'default', ?)", (host, p.at(-age)))
    ranks = {}
    for name, host, status, age in (
            ('r0', 'h1', JaxStatus.InProgress, 300),
            ('r1', 'h2', JaxStatus.InProgress, 300),
            ('r2', 'h3', JaxStatus.Queued, 5),
            ('r3', 'h4', JaxStatus.InProgress, 600)):
        ranks[name] = p.add_task(name, status=status, parent=parent,
                                 computer=host, age_s=age, gang_id='g1',
                                 gang_generation=2)
    found = p.evaluate(rule='gang-stall')
    assert [f['task'] for f in found] == [ranks['r1'], ranks['r3']]
    assert found[0]['details'] == {'age_s': 300.0, 'gang': 'g1',
                                   'generation': 2, 'parent': parent}


RULES = {
    'stall': _stall, 'live_heartbeat': _live_heartbeat,
    'fresh_sample_is_life': _fresh_sample_is_life,
    'siblings_pool': _siblings_pool,
    'children_pool_into_parent': _children_pool_into_parent,
    'dedup': _dedup, 'rate_limit': _rate_limit,
    'regression': _regression, 'steady': _steady,
    'shallow_step_window': _shallow_step_window,
    'finished_sweep_keeps_stall_alerts': _finished_sweep_keeps_stall_alerts,
    'regression_recovers': _regression_recovers,
    'straggler': _straggler,
    'two_children_are_not_enough': _two_children_are_not_enough,
    'hbm_over_threshold': _hbm_over_threshold,
    'hbm_steep_rise': _hbm_steep_rise, 'hbm_shallow_rise': _hbm_shallow_rise,
    'hbm_noisy_rise': _hbm_noisy_rise, 'hbm_falling': _hbm_falling,
    'hbm_flat_low': _hbm_flat_low, 'hbm_stepless_gauges': _hbm_stepless_gauges,
    'recompile_storm': _recompile_storm,
    'warmup_builds_are_free': _warmup_builds_are_free,
    'below_storm_count': _below_storm_count, 'old_storm': _old_storm,
    'storm_threshold_override': _storm_threshold_override,
    'exposed_comm': _exposed_comm,
    'comm_bound_baseline': _comm_bound_baseline,
    'shallow_devtime': _shallow_devtime, 'sub_floor_wobble': _sub_floor_wobble,
    'gang_stall': _gang_stall,
}


@pytest.mark.parametrize('case', sorted(RULES))
def test_rules_give_jax_findings_and_alerts(pair, case):
    RULES[case](pair)


def test_a_crashing_rule_is_logged_and_the_others_run(pair, monkeypatch):
    from mlcomp_tpu.utils.logging import create_logger as jax_logger
    from mlcomp_tpu_torch.utils.logging import create_logger
    task = pair.add_task(age_s=120)
    pair.watch(stall_deadline_s=30)
    for wd, logger in zip(pair.watchdogs, (jax_logger(pair.jax),
                                           create_logger(pair.port))):
        wd.logger = logger
        monkeypatch.setattr(wd, '_check_hbm', lambda *a: 1 / 0)
    (f,) = pair.evaluate()
    assert (f['rule'], f['task']) == ('task-stall', task)
    for session in (pair.jax, pair.port):
        (row,) = session.query("SELECT message FROM log WHERE message "
                               "LIKE 'watchdog rule failed%'")
        assert 'ZeroDivisionError' in row['message']


def test_unknown_watchdog_and_slo_options_raise_as_jax():
    for config, jax_config in ((WatchdogConfig, JaxWatchdogConfig),
                               (SloConfig, JaxSloConfig)):
        with pytest.raises(TypeError) as mine:
            config(not_an_option=1)
        with pytest.raises(TypeError) as theirs:
            jax_config(not_an_option=1)
        assert str(mine.value) == str(theirs.value)
        assert vars(config()) == vars(jax_config())
        assert {k: v for k, v in vars(config).items()
                if not k.startswith('_')} == \
            {k: v for k, v in vars(jax_config).items()
             if not k.startswith('_')}


_OCCUPANCY = st.lists(
    st.tuples(st.one_of(st.none(), st.integers(0, 10 ** 6)),
              st.floats(0.0, 1.5, allow_nan=False)),
    min_size=0, max_size=12)


@settings(max_examples=200, deadline=None)
@given(points=_OCCUPANCY)
def test_oom_prediction_gives_jaxs(points):
    """Newest-first (step, occupancy) windows, steps possibly missing:
    the same (slope, steps to OOM), bit for bit."""
    assert Watchdog._oom_prediction(points) == \
        JaxWatchdog._oom_prediction(points)


def test_a_recorder_flush_counts_as_life(pair):
    """A task silent for 600 s stalls in both; a flush of each package's
    recorder (one sample) touches ``last_activity``, and neither
    watchdog finds a stall after it."""
    task = pair.add_task(age_s=600)
    real = now()
    assert len(pair.watch(stall_deadline_s=60).evaluate(
        at=(real - pair.t0).total_seconds())) == 1
    for recorder_cls, session in ((JaxRecorder, pair.jax),
                                  (MetricRecorder, pair.port)):
        rec = recorder_cls(session=session, task=task, component='train',
                           flush_every=10 ** 9)
        rec.gauge('loss', 0.5, step=0)
        assert rec.flush() == 1
    for session in (pair.jax, pair.port):
        fresh = TaskProvider(session).by_id(task).last_activity
        assert (now() - fresh).total_seconds() < 30
    # a clock past the flush but inside the deadline: alive in both
    later = (now() - pair.t0).total_seconds() + 1
    for wd in pair.watchdogs:
        assert [f for f in wd.evaluate(now_dt=pair.at(later))
                if f['rule'] == 'task-stall'] == []


# ------------------------------------------------------------------ SLOs
KEY = 'dispatch-p99'


def _fast_burn(p):
    p.sli(KEY, [(age, 1.0) for age in range(0, 3600, 60)])
    (f,) = p.judge()
    assert (f['rule'], f['severity']) == ('slo-' + KEY, 'critical')
    assert f['burn'] >= SloConfig.fast_burn


def _long_window_vetoes_a_blip(p):
    p.sli(KEY, [(age, 1.0) for age in range(0, 300, 60)]
          + [(age, 0.0) for age in range(300, 21600, 60)])
    assert p.judge() == [] and _alerts(p.port) == []


def _slow_burn(p):
    p.sli(KEY, [(age, 0.1) for age in range(0, 21600, 600)])
    (f,) = p.judge()
    assert f['severity'] == 'warning'


def _auto_resolve(p):
    p.sli(KEY, [(age, 1.0) for age in range(0, 3600, 60)])
    p.judge()
    p.sli(KEY, [(-7 * 3600 + age, 0.0) for age in range(0, 300, 60)])
    (f,) = p.judge(at=7 * 3600)
    assert (f['severity'], f['alert_id']) == ('resolved', None)
    assert [a['status'] for a in _alerts(p.port)] == ['resolved']


def _slo_rate_limit(p):
    p.slo(evaluate_every_s=3600)
    p.sli(KEY, [(0, 1.0)])
    assert len(p.judge(maybe=True)) == 1
    assert p.judge(at=5, maybe=True) == []


def _latency_row(p, name, value, age_s=0.0):
    p.both("INSERT INTO metric (task, name, kind, step, value, time, "
           "component, tags) VALUES (NULL, ?, 'histogram', NULL, ?, ?, "
           "'supervisor', ?)", (name, float(value), p.at(-age_s),
                               json.dumps({'of': name.rsplit('.', 1)[0]})))


def _dispatch_objective(p):
    """A flushed p99 over the objective measures bad 1.0, one under it
    0.0, a stale one (past the 900 s horizon) nothing."""
    _latency_row(p, 'supervisor.dispatch_latency_s.p99', 9.0)
    p.judge()
    _latency_row(p, 'supervisor.dispatch_latency_s.p99', 0.5)
    p.judge(at=1)
    p.judge(at=1000)
    assert [r[3] for r in _slo_rows(p.port)
            if r[0] == f'slo.{KEY}.bad'] == [1.0, 0.0]


def _queue_wait_objective(p):
    """``queue.wait_s.<class>.p95`` as JAX's engine reads it."""
    _latency_row(p, 'queue.wait_s.train.p95', 700.0)
    _latency_row(p, 'queue.wait_s.sweep.p95', 30.0)
    p.judge()
    assert {r[0]: r[3] for r in _slo_rows(p.port)
            if r[0].endswith('.bad')} == {
        'slo.queue-wait-train.bad': 1.0, 'slo.queue-wait-sweep.bad': 0.0}


def _fleet(p, name, slo_p99_ms=250.0, status='active'):
    p.both('INSERT INTO serve_fleet (name, model, desired, status, '
           'slo_p99_ms, created) VALUES (?, ?, 2, ?, ?, ?)',
           (name, 'm', status, slo_p99_ms, p.at()))


def _fleet_objectives(p):
    """p99 from the gateway's fleet row, else the replicas' serving
    row; availability off the cumulative gauges, the first sample a
    watermark only, a counter reset (a restarted gateway) no verdict."""
    _fleet(p, 'a')
    _fleet(p, 'b', slo_p99_ms=100.0)
    _fleet(p, 'gone', status='stopped')
    _latency_row(p, 'fleet.a.latency_ms.p99', 300.0)
    _latency_row(p, 'serving.b.latency_ms.p99', 50.0)
    for i, (reqs, shed) in enumerate(((100, 0), (300, 10), (350, 60),
                                      (20, 0))):
        for fleet in ('a', 'b'):
            for name, value in (('requests_cum', reqs), ('shed_cum', shed)):
                p.both("INSERT INTO metric (task, name, kind, step, value, "
                       "time, component, tags) VALUES (NULL, ?, 'gauge', "
                       "NULL, ?, ?, 'gateway', NULL)",
                       (f'fleet.{fleet}.{name}', float(value), p.at(i)))
        p.judge(at=i)
    bad = [(r[0], r[3]) for r in _slo_rows(p.port)
           if r[0].startswith('slo.serving-') and r[0].endswith('.bad')]
    assert bad == [
        ('slo.serving-p99-a.bad', 1.0), ('slo.serving-p99-b.bad', 0.0),
        ('slo.serving-p99-a.bad', 1.0),
        ('slo.serving-availability-a.bad', 0.05),
        ('slo.serving-p99-b.bad', 0.0),
        ('slo.serving-availability-b.bad', 0.05),
        ('slo.serving-p99-a.bad', 1.0),
        ('slo.serving-availability-a.bad', 1.0),
        ('slo.serving-p99-b.bad', 0.0),
        ('slo.serving-availability-b.bad', 1.0),
        ('slo.serving-p99-a.bad', 1.0), ('slo.serving-p99-b.bad', 0.0)]
    assert p.engines[1]._fleet_seen == p.engines[0]._fleet_seen


def _step_time_objective(p):
    """Two judged tasks (one regressed), one with a shallow window."""
    for name, values in (('slow', [100] * 20 + [300] * 5),
                         ('fine', [100] * 25), ('shallow', [900] * 3)):
        p.series(p.add_task(name), 'step_time_ms', values)
    p.judge()
    (row,) = [r for r in _slo_rows(p.port) if r[0] == 'slo.step-time.bad']
    assert row[3] == 0.5


SLOS = {
    'fast_burn': _fast_burn, 'long_window_vetoes_a_blip':
        _long_window_vetoes_a_blip, 'slow_burn': _slow_burn,
    'auto_resolve': _auto_resolve, 'rate_limit': _slo_rate_limit,
    'dispatch_objective': _dispatch_objective,
    'queue_wait_objective': _queue_wait_objective,
    'fleet_objectives': _fleet_objectives,
    'step_time_objective': _step_time_objective,
}


@pytest.mark.parametrize('case', sorted(SLOS))
def test_slo_engine_gives_jax_rows_and_alerts(pair, case):
    SLOS[case](pair)


def test_slo_status_gives_jaxs_scoreboard(pair):
    from tests.test_torch_port_api import normalise
    pair.sli(KEY, [(age, 1.0) for age in range(0, 3600, 60)])
    _latency_row(pair, 'queue.wait_s.train.p95', 10.0)
    pair.judge()
    mine, theirs = slo_status(pair.port), jax_slo_status(pair.jax)
    assert normalise(mine) == normalise(theirs)
    by_key = {e['key']: e for e in mine}
    assert by_key[KEY]['status'] == 'critical'
    assert by_key[KEY]['alert']['rule'] == 'slo-' + KEY
    assert by_key['queue-wait-train'] == {
        'key': 'queue-wait-train', 'bad': 0.0, 'burn_fast': 0.0,
        'burn_slow': 0.0, 'alert': None, 'status': 'ok'}


def test_queue_wait_reads_the_ticks_per_priority_series(pair):
    """The tick's recorder writes ``queue.wait_s.<class>.<priority>.*``.
    JAX's engine reads only ``queue.wait_s.<class>.p95`` and measures no
    queue-wait objective over those rows; the port's takes the worst
    fresh p95 of the class's priorities. Everything else stays JAX's."""
    _latency_row(pair, 'queue.wait_s.train.normal.p95', 12.0)
    _latency_row(pair, 'queue.wait_s.train.high.p95', 800.0)
    _latency_row(pair, 'queue.wait_s.sweep.preemptible.p95', 3.0)
    _latency_row(pair, 'queue.wait_s.service.normal.p95', 2000.0,
                 age_s=3600)             # stale: no evidence
    jax_engine = JaxSloEngine(pair.jax)
    engine = SloEngine(pair.port)
    assert jax_engine.evaluate(now_dt=pair.at()) == []
    assert [(f['rule'], f['severity']) for f in
            engine.evaluate(now_dt=pair.at())] == [
        ('slo-queue-wait-train', 'critical')]
    bad = {r[0]: r[3] for r in _slo_rows(pair.port)}
    assert bad == pytest.approx({'slo.queue-wait-train.bad': 1.0,
                                 'slo.queue-wait-sweep.bad': 0.0,
                                 'slo.queue-wait-train.burn_fast': 100.0,
                                 'slo.queue-wait-train.burn_slow': 100.0,
                                 'slo.queue-wait-sweep.burn_fast': 0.0,
                                 'slo.queue-wait-sweep.burn_slow': 0.0})
    assert _slo_rows(pair.jax) == []
    keyed = [o for o in engine.objectives(pair.at())
             if o[0].startswith('queue-wait-')]
    assert [(o[0], o[2], o[4]) for o in keyed] == [
        ('queue-wait-train', 1.0, {'p95_s': 800.0}),
        ('queue-wait-sweep', 0.0, {'p95_s': 3.0}),
        ('queue-wait-serve-replica', None, None),
        ('queue-wait-service', None, None)]


# -------------------------------------------------------------- the tick
@pytest.fixture()
def twin(tmp_path):
    t = Twin(tmp_path)
    yield t
    t.close()


def _tick(twin):
    """One tick of each package: the state ``Twin.tick`` compares, and
    the watchdog's and SLO engine's entries of the decision trace."""
    st = twin.tick()
    for key in ('watchdog', 'slo'):
        assert twin.port_sup.aux.get(key) == twin.jax_sup.aux.get(key), key
    st['aux'].update({k: twin.port_sup.aux.get(k)
                      for k in ('watchdog', 'slo')})
    return st


#: tick gauges whose values are wall clocks of this process
_WALL = ('supervisor.tick_ms', 'supervisor.preempt_ms',
         'supervisor.usage_fold_ms', 'supervisor.slo_eval_ms')
#: waits measured against a time that each package's tick stamped (a
#: re-delivery's claim, the clock of the starvation gauges)
_CLOCKED = ('queue.max_wait_s.', 'queue.wait_s.',
            'supervisor.dispatch_latency_s.')


def _recorded(twin) -> list:
    """Both builders' recorders flushed: the supervisor's metric rows of
    each DB equal (wall-clock gauges by name only, waits measured against
    a package's clock within 0.5 s); the port's returned as (name, kind,
    step, value, tags)."""
    out = []
    for sup, session in ((twin.jax_sup, twin.jax),
                         (twin.port_sup, twin.port)):
        sup.telemetry.flush()
        out.append([
            (r['name'], r['kind'], r['step'],
             None if r['name'] in _WALL else
             TickSeconds(r['value']) if r['name'].startswith(_CLOCKED)
             else r['value'], r['tags'])
            for r in session.query(
                "SELECT * FROM metric WHERE component='supervisor' "
                "ORDER BY id")])
    theirs, mine = out
    assert mine == theirs
    return mine


def _names(rows) -> dict:
    out = {}
    for name, _, _, value, _ in rows:
        out.setdefault(name, []).append(value)
    return out


def _quota_denied(twin):
    twin.computer('host1', cores=2)
    twin.task('held', owner='alice')
    twin.start()
    twin.both("INSERT INTO quota (scope, tenant, resource, limit_value, "
              "window_s, created, updated) VALUES ('owner', 'alice', "
              "'cores', 0, 86400, ?, ?)", (now(), now()))
    _tick(twin)
    return {'scheduler.quota_denied': [1.0], 'supervisor.not_placed': [1.0]}


def _preemption(twin):
    twin.computer('host1', cores=1)
    twin.task('victim', status=JaxStatus.InProgress, priority='preemptible',
              computer_assigned='host1', cores_assigned='[0]')
    twin.task('boss', priority='high')
    twin.start()
    st = _tick(twin)
    assert [p['class'] for p in st['aux']['preempted']] == ['preemptible']
    return {'supervisor.preemptions': [1.0], 'scheduler.preemption': [1.0],
            'supervisor.usage_folds': [1.0]}


def _usage_fold(twin):
    twin.computer('host1')
    twin.task('done', status=JaxStatus.Success, started=_ago(60),
              finished=_ago(10), cores_assigned='[0]')
    twin.start()
    _tick(twin)
    return {'supervisor.usage_folds': [1.0]}


def _lease_reclaimed(twin):
    twin.computer('host1')
    twin.computer('dead', alive=False)
    task = twin.task('claimed_on_dead', status=JaxStatus.Queued,
                     computer_assigned='dead', cores_assigned='[0]')
    twin.message(task, 'dead_default', status='claimed',
                 claimed_by='dead:0', claimed_at=_ago(600))
    twin.start()
    _tick(twin)
    return {'supervisor.lease_reclaimed': [1.0]}


def _task_retries(twin):
    twin.computer('host1')
    twin.task('due', status=JaxStatus.Failed, failure_reason='stall-killed',
              computer_assigned='host1', next_retry_at=_ago(600))
    twin.start()
    st = _tick(twin)
    assert [(r['reason'], r['attempt']) for r in st['aux']['retried']] == [
        ('stall-killed', 1)]
    return {'supervisor.task_retries': [1.0], 'task.retry': [1.0],
            'supervisor.dispatched': [1.0]}


def _gang_requeues(twin):
    twin.computer('host1')
    twin.task('gang', status=JaxStatus.Failed, failure_reason='worker-lost',
              gang_id='g1', gang_generation=1, next_retry_at=_ago(600))
    twin.start()
    _tick(twin)
    return {'supervisor.gang_requeues': [1.0],
            'supervisor.task_retries': [1.0], 'task.retry': [1.0],
            'gang.generation': [1.0], 'supervisor.dispatched': [1.0]}


def _gang_aborted_ranks(twin):
    from mlcomp_tpu.db.enums import TaskType as JaxType
    twin.computer('host1')
    gang = twin.task('parent_gang', status=JaxStatus.InProgress,
                     gang_id='g1', gang_generation=1)
    twin.task('rank_failed', status=JaxStatus.Failed, parent=gang,
              failure_reason='preempted', computer_assigned='host2',
              type=int(JaxType.Service))
    twin.task('rank_alive', status=JaxStatus.InProgress, parent=gang,
              computer_assigned='host2', cores_assigned='[1]', gang_id='g1',
              type=int(JaxType.Service))
    twin.start()
    _tick(twin)
    return {'supervisor.gang_aborted_ranks': [1.0],
            'supervisor.usage_folds': [3.0]}


RECORDER_CALLS = {
    'quota_denied': _quota_denied, 'preemption': _preemption,
    'usage_fold': _usage_fold, 'lease_reclaimed': _lease_reclaimed,
    'task_retries': _task_retries, 'gang_requeues': _gang_requeues,
    'gang_aborted_ranks': _gang_aborted_ranks,
}


@pytest.mark.parametrize('case', sorted(RECORDER_CALLS))
def test_each_recorder_call_writes_jaxs_row(twin, case):
    """One tick of a scenario that makes the call: every supervisor row
    of the tick equal to JAX's, the wanted counts among them, and the
    tick's gauges present (``preempt_ms``, ``usage_fold_ms`` and
    ``slo_eval_ms`` every tick)."""
    want = RECORDER_CALLS[case](twin)
    names = _names(_recorded(twin))
    for name, values in want.items():
        assert names.get(name) == values, (name, names.get(name))
    assert {'supervisor.tick_ms', 'supervisor.preempt_ms',
            'supervisor.usage_fold_ms', 'supervisor.slo_eval_ms'} <= \
        set(names)


def test_a_prune_counts_into_the_tick_recorder_as_jax(tmp_path):
    """The sweep scheduler counts ``supervisor.sweep_pruned`` into the
    builder's recorder, as JAX's does."""
    from tests.test_torch_port_sweep import SweepTwin, _front_two
    twin = SweepTwin(tmp_path)
    try:
        running = _front_two(twin)
        for cell, value in zip(running, (0.9, 0.2)):
            twin.report(cell, 1, value)
        twin.tick()
        names = _names(_recorded(twin))
    finally:
        twin.close()
    assert names['supervisor.sweep_pruned'] == [1.0]


def test_a_respawn_counts_into_the_tick_recorder_as_jax(tmp_path):
    """The fleet reconciler counts ``supervisor.fleet_respawns`` into
    the builder's recorder, as JAX's does."""
    from tests.test_torch_port_fleet import (
        FleetTwin, _create, bring_up, expire_probes,
    )
    twin = FleetTwin(tmp_path)
    try:
        for host in ('h1', 'h2', 'h3'):
            twin.computer(host)
        twin.start()
        fid = _create(twin, desired=2)
        twin.tick()
        twin.each(lambda pkg, s: bring_up(pkg, s, fid))
        st = twin.tick()
        twin.health[st['replicas'][0]['url']] = False
        for _ in range(3):
            expire_probes(twin)
            twin.tick()
        names = _names(_recorded(twin))
    finally:
        twin.close()
    assert names['supervisor.fleet_respawns'] == [1.0]


def test_dispatch_latency_queue_wait_and_starvation_gauges(twin):
    """Tick 1 dispatches two tasks (a train task, a replica) and holds a
    third (pinned to a dead host); the worker claims the first two 45
    and 20 s after their messages; tick 2 observes both waits into
    ``supervisor.dispatch_latency_s`` and ``queue.wait_s.<class>.
    <priority>``, and a pending message 120 s old shows in
    ``queue.max_wait_s.train``, the other classes at 0."""
    twin.computer('host1', cores=4)
    twin.computer('dead', alive=False)
    train = twin.task('train')
    replica = twin.task('replica', type=3, priority='high')
    twin.jax.execute("UPDATE task SET executor='serve_replica' WHERE id=?",
                     (replica,))
    twin.task('pinned', computer='dead')
    old = twin.task('old_pending', status=JaxStatus.Queued,
                    computer_assigned='host1', cores_assigned='[3]')
    twin.message(old, 'host1_default', created=_ago(120))
    twin.start()
    st = _tick(twin)
    assert set(_dispatched_ids(st)) == {train, replica}
    for task, waited in ((train, 45), (replica, 20)):
        msg = twin.port.query_one('SELECT queue_id FROM task WHERE id=?',
                                  (task,))['queue_id']
        twin.both("UPDATE queue_message SET status='claimed', "
                  "claimed_by='host1:0', created=?, claimed_at=? "
                  "WHERE id=?", (_ago(waited - 1), _ago(-1), msg))
    _tick(twin)
    names = _names(_recorded(twin))
    assert names['supervisor.dispatched'] == [2.0]
    assert names['supervisor.not_placed'] == [1.0, 1.0]
    assert names['supervisor.dispatch_latency_s.count'] == [2.0]
    (longest,) = names['supervisor.dispatch_latency_s.max']
    assert float(longest) == pytest.approx(45, abs=1)
    assert names['queue.wait_s.train.normal.count'] == [1.0]
    assert names['queue.wait_s.serve-replica.high.count'] == [1.0]
    assert float(names['queue.max_wait_s.train'][-1]) == \
        pytest.approx(120, abs=5)
    for cls in ('sweep', 'serve-replica', 'service'):
        assert names[f'queue.max_wait_s.{cls}'] == [0.0, 0.0]


def _dispatched_ids(st):
    return [d['task'] for d in st['aux']['dispatched'] or []]


def test_tick_deltas_and_epoch_give_jaxs_rows(twin, monkeypatch):
    """The process-wide counters' deltas since the last tick (busy
    retries and give-ups, listener reconnects, fenced writes), the lease
    epoch, the dispatch and unplaced counts, from the same decision
    trace; a second call with no new counts writes no delta rows."""
    from types import SimpleNamespace
    twin.start()
    stats = {'busy': {'retries': 0, 'gave_up': 0}, 'listen': 0, 'fence': 0}

    def patch(module_core, module_events, module_fencing):
        monkeypatch.setattr(module_core, 'busy_retry_stats',
                            lambda: dict(stats['busy']))
        monkeypatch.setattr(module_events, 'listener_stats',
                            lambda: {'reconnects': stats['listen']})
        monkeypatch.setattr(module_fencing, 'fence_rejections',
                            lambda: stats['fence'])

    patch(jax_core, jax_events, jax_fencing)
    patch(port_supervisor, port_supervisor, port_supervisor)
    for sup in (twin.jax_sup, twin.port_sup):
        sup._busy_seen = dict(stats['busy'])
        sup._listener_seen = {'reconnects': 0}
        sup._fence_seen = 0
        sup.lease = SimpleNamespace(epoch=4)
    stats.update(busy={'retries': 3, 'gave_up': 1}, listen=2, fence=5)
    aux = {'duration': 0.25, 'dispatched': [{'task': 1}, {'task': 2}],
           'not_placed': {'3': {'h': 'no'}}}
    for _ in range(2):
        for sup in (twin.jax_sup, twin.port_sup):
            sup.aux = dict(aux)
            sup.record_tick_telemetry()
    names = _names(_recorded(twin))
    assert {k: v for k, v in names.items()
            if not k.startswith('queue.max_wait_s.')} == {
        'supervisor.tick_ms': [None, None], 'supervisor.epoch': [4.0, 4.0],
        'supervisor.not_placed': [1.0, 1.0], 'db.busy_retries': [3.0],
        'db.busy_gave_up': [1.0], 'db.listener_reconnects': [2.0],
        'supervisor.fenced_writes': [5.0], 'supervisor.dispatched': [4.0]}


def test_a_crashing_watchdog_or_slo_engine_never_breaks_the_tick(
        twin, monkeypatch):
    from mlcomp_tpu.utils.logging import create_logger as jax_logger
    from mlcomp_tpu_torch.utils.logging import create_logger
    twin.computer('host1')
    placed = twin.task('placed')
    twin.start()
    for sup, logger in ((twin.jax_sup, jax_logger(twin.jax)),
                        (twin.port_sup, create_logger(twin.port))):
        sup.logger = logger
        for engine in (sup.watchdog, sup.slo_engine):
            monkeypatch.setattr(engine, 'maybe_evaluate',
                                lambda *a, **k: 1 / 0)
    st = _tick(twin)
    assert _dispatched_ids(st) == [placed]
    for session in (twin.jax, twin.port):
        lines = [r['message'].split('\n')[0] for r in session.query(
            "SELECT message FROM log WHERE message LIKE '%evaluation "
            "failed%' ORDER BY id")]
        assert lines == ['watchdog evaluation failed:',
                         'slo evaluation failed:']
    names = _names(_recorded(twin))
    assert 'supervisor.slo_eval_ms' in names


def test_fence_loss_propagates_from_both_under_a_zombie_lease(twin,
                                                              monkeypatch):
    """A zombie's stall kill hits the fence at its first task write and
    raises in both packages (the task stays InProgress; the alert, on an
    unfenced table, is written); the SLO engine's ``FenceLostError``
    propagates, the watchdog evaluation's is contained, as in JAX."""
    from mlcomp_tpu.db.fencing import FenceLostError as JaxFenceLost
    from mlcomp_tpu.server.ha import StaticLease as JaxStaticLease
    from mlcomp_tpu_torch.db.fencing import FenceLostError
    from mlcomp_tpu_torch.server.ha import StaticLease
    twin.computer('host1')
    stalled = twin.task('stalled', status=JaxStatus.InProgress,
                        computer_assigned='host1', cores_assigned='[0]',
                        waited=4000)
    twin.jax.execute('UPDATE supervisor_lease SET epoch=5, holder=? '
                     'WHERE id=1', ('live:leader:xyz',))
    twin.start()
    zombies = (JaxSupervisor(session=twin.jax, lease=JaxStaticLease(3)),
               SupervisorBuilder(session=twin.port, lease=StaticLease(3)))
    for sup, error in zip(zombies, (JaxFenceLost, FenceLostError)):
        with pytest.raises(error):
            sup.build()
    for session in (twin.jax, twin.port):
        assert [tuple(r) for r in session.query(
            'SELECT status, failure_reason FROM task')] == [
            (int(TaskStatus.InProgress), None)]
        assert [(r['rule'], r['task']) for r in session.query(
            'SELECT rule, task FROM alert')] == [('task-stall', stalled)]
    for sup, error in zip(zombies, (JaxFenceLost, FenceLostError)):
        def fenced(*a, _error=error, **k):
            raise _error('zombie')
        monkeypatch.setattr(sup.slo_engine, 'maybe_evaluate', fenced)
        with pytest.raises(error):
            sup.run_slo()
        monkeypatch.setattr(sup.watchdog, 'maybe_evaluate', fenced)
        sup.run_watchdog()              # contained, as JAX's


def test_the_reclaim_horizon_follows_stall_deadline(twin):
    """A claim of a dead host whose InProgress task was last seen 300 s
    ago: kept at the default 1800 s deadline, reclaimed once the
    watchdog's deadline is 120 s, in both packages."""
    twin.computer('host1')
    twin.computer('dead', alive=False)
    task = twin.task('quiet', status=JaxStatus.InProgress, waited=300,
                     computer_assigned='dead', cores_assigned='[0]')
    msg = twin.message(task, 'dead_default', status='claimed',
                       claimed_by='dead:0', claimed_at=_ago(600))
    twin.start()
    assert _tick(twin)['aux']['lease_reclaimed'] is None
    twin.jax_sup.watchdog.config = JaxWatchdogConfig(stall_deadline_s=120)
    twin.port_sup.watchdog.config = WatchdogConfig(stall_deadline_s=120)
    st = _tick(twin)
    assert [r['msg'] for r in st['aux']['lease_reclaimed']] == [msg]
    assert {t[0]: t[2] for t in st['tasks']}[task] in (
        int(TaskStatus.Queued), int(TaskStatus.NotRan))


def test_a_stalled_task_is_failed_killed_and_retried_as_jax(twin):
    """The stall action in the tick: ``Failed``/``stall-killed``, the
    queue message revoked or failed as JAX's kill leaves it, the alert
    and the watchdog's decision trace; after the backoff the retry pass
    requeues it once as attempt 1, and the stall alert stays open."""
    twin.computer('host1')
    stalled = twin.task('stalled', status=JaxStatus.InProgress,
                        computer_assigned='host1', cores_assigned='[0]',
                        waited=4000)
    twin.message(stalled, 'host1_default', status='claimed',
                 claimed_by='host1:0', claimed_at=_ago(4000))
    twin.start()
    st = _tick(twin)
    row = {t[0]: t for t in st['tasks']}[stalled]
    assert (row[2], row[6]) == (int(TaskStatus.Failed), 'stall-killed')
    assert st['aux']['watchdog'][0]['rule'] == 'task-stall'
    assert st['alerts'] == [('task-stall', stalled, 'critical', 'open')]
    st = _tick(twin)                # the backoff is scheduled
    twin.both('UPDATE task SET next_retry_at=? WHERE id=?',
              (_ago(60), stalled))
    st = _tick(twin)
    assert [(r['task'], r['attempt'], r['reason'])
            for r in st['aux']['retried']] == [(stalled, 1, 'stall-killed')]
    assert st['alerts'] == [('task-stall', stalled, 'critical', 'open')]


def test_gang_stall_fails_the_rank_and_aborts_the_gang_as_jax(twin):
    """A rank whose host went silent 400 s ago: ``worker-lost``, its kill
    routed to its host, the surviving rank gang-aborted, the parent
    Failed with the aggregated reason, one ``gang-stall`` alert."""
    from mlcomp_tpu.db.enums import TaskType as JaxType
    twin.computer('h1')
    twin.computer('h2', alive=False)
    gang = twin.task('gang', status=JaxStatus.InProgress, gang_id='g1',
                     gang_generation=1)
    alive = twin.task('r0', status=JaxStatus.InProgress, parent=gang,
                      computer_assigned='h1', cores_assigned='[0]',
                      gang_id='g1', type=int(JaxType.Service), waited=100,
                      pid=2 ** 22)
    silent = twin.task('r1', status=JaxStatus.InProgress, parent=gang,
                       computer_assigned='h2', cores_assigned='[0]',
                       gang_id='g1', type=int(JaxType.Service), waited=400,
                       pid=2 ** 22)
    twin.start()
    st = _tick(twin)
    rows = {t[0]: (t[2], t[6]) for t in st['tasks']}
    assert rows == {gang: (int(TaskStatus.Failed), 'worker-lost'),
                    alive: (int(TaskStatus.Failed), 'gang-aborted'),
                    silent: (int(TaskStatus.Failed), 'worker-lost')}
    assert ('gang-stall', silent, 'critical', 'open') in st['alerts']
    assert [m[1:4] for m in st['messages']] == [
        ('h2_default_supervisor', 'pending',
         {'action': 'kill', 'task_id': silent}),
        ('h1_default_supervisor', 'pending',
         {'action': 'kill', 'task_id': alive})]


# -------------------------------------------------------------- the kill
from tests.test_torch_port_quota import (  # noqa: E402 (helpers reused)
    FAST_RETRY, _mlp_train, _submit_code, _wait,
)
from tests.test_torch_port_worker import _consume, daemon  # noqa: E402

_ = daemon

#: an executor that marks its start with the file ``started``, then hangs
#: silently; its exit, SIGTERM's ``SystemExit`` included, waits for the
#: file ``release``
STALL_HANG = '''
import os
import time

from mlcomp_tpu_torch.worker.executors import Executor


@Executor.register
class StallHang(Executor):
    def __init__(self, started=None, release=None, **kwargs):
        self.started = started
        self.release = release

    def work(self):
        open(self.started, 'w').close()
        try:
            time.sleep(120)
        finally:
            deadline = time.monotonic() + 60
            while not os.path.exists(self.release) and \\
                    time.monotonic() < deadline:
                time.sleep(0.05)
        return {}
'''


def _stall_ticker(session):
    """A logged supervisor with the fast retry backoff and a watchdog
    evaluating every tick; ``deadline(s)`` sets its stall deadline."""
    from mlcomp_tpu_torch.utils.logging import create_logger
    sup = SupervisorBuilder(session=session, logger=create_logger(session),
                            recovery_config=RecoveryConfig(**FAST_RETRY))

    def deadline(seconds):
        sup.watchdog.config = WatchdogConfig(stall_deadline_s=seconds,
                                             evaluate_every_s=0)

    def tick():
        DockerProvider(session).heartbeat('host1', 'default')
        sup.build()
    deadline(3600)
    return sup, tick, deadline


def _stall_alerts(session):
    return [(r['rule'], r['task'], r['severity'], r['status'])
            for r in session.query('SELECT * FROM alert ORDER BY id')]


def _watchdog_lines(session, task):
    return [r['message'] for r in session.query(
        "SELECT message FROM log WHERE task=? AND message LIKE "
        "'watchdog: %' ORDER BY id", (task,))]


def test_a_hung_trainer_is_stall_killed_retried_and_resumed(
        daemon, tmp_path, monkeypatch):
    """A ``run-task`` MLP trainer (5 epochs, a checkpoint an epoch, its
    telemetry on) hangs at the ``train.epoch`` seam after epoch 1, as
    ``MLCOMP_FAULTS`` arms it for its processes. Once its epoch-1
    checkpoint is on disk the watchdog's deadline drops to 2 s: one
    ``task-stall`` alert, the row ``Failed``/``stall-killed`` and its
    process SIGTERMed (exit 143; the worker's verdict leaves the row as
    it is), the log line naming the alert. With the deadline back at
    3600 s, the retry pass requeues it once, attempt 1 resumes at
    epoch 2 and ends Success with every epoch trained once; the stall
    alert stays open and no second one is raised."""
    import mlcomp_tpu_torch
    from mlcomp_tpu_torch.train.checkpoint import load_meta
    monkeypatch.setenv('MLCOMP_FAULTS', json.dumps({'train.epoch': {
        'action': 'sleep', 'ms': 120000, 'when': {'epoch': 2}}}))
    session, provider = daemon, TaskProvider(daemon)
    spec = _mlp_train(5)
    spec.pop('telemetry')
    spec.pop('async_checkpoint')
    (task,) = _submit_code(session, tmp_path, 'hung', {
        'info': {'name': 'hung', 'project': 'p_hung'},
        'executors': {'train': spec}})['train']
    sup, tick, deadline = _stall_ticker(session)
    stop = threading.Event()

    def slot():
        while not stop.is_set():
            if not _consume(session, in_process=False):
                time.sleep(0.05)

    consumer = threading.Thread(target=slot)
    ck_dir = f'{mlcomp_tpu_torch.TASK_FOLDER}/{task}/checkpoints'
    try:
        consumer.start()
        tick()
        first_msg = provider.by_id(task).queue_id
        _wait('checkpoint of epoch 1', lambda: (
            load_meta(ck_dir) or {}).get('epoch', -1) >= 1)
        deadline(2)

        def killed():
            tick()
            return provider.by_id(task).status == int(TaskStatus.Failed)
        _wait('the stall kill', killed, timeout=30)
        deadline(3600)
        row = provider.by_id(task)
        assert (row.failure_reason, row.attempt or 0) == ('stall-killed', 0)
        _wait('the exit of the hung process', lambda: session.query_one(
            'SELECT status FROM queue_message WHERE id=?',
            (first_msg,))['status'] == 'failed')

        def finished():
            tick()
            return provider.by_id(task).status == int(TaskStatus.Success)
        _wait('attempt 1 Success', finished, timeout=120)
    finally:
        stop.set()
        consumer.join(timeout=60)
    msg = session.query_one('SELECT status, result FROM queue_message '
                            'WHERE id=?', (first_msg,))
    assert tuple(msg) == ('failed', 'subprocess failed (rc=143)')
    row = provider.by_id(task)
    assert (row.status, row.attempt) == (int(TaskStatus.Success), 1)
    (alert_id,) = [r['id'] for r in session.query('SELECT id FROM alert')]
    assert _stall_alerts(session) == [
        ('task-stall', task, 'critical', 'open')]
    (line,) = _watchdog_lines(session, task)
    assert line.endswith(f'task marked Failed (alert {alert_id})')
    retries = session.query("SELECT tags FROM metric WHERE task=? AND "
                            "name='task.retry'", (task,))
    assert [json.loads(r['tags'])['reason'] for r in retries] == [
        'stall-killed']
    resumed = [r['message'] for r in session.query(
        "SELECT message FROM log WHERE task=? AND message LIKE "
        "'resumed from checkpoint%'", (task,))]
    assert len(resumed) == 1 and 'epoch=1 ' in resumed[0]
    epochs = [r['epoch'] for r in session.query(
        "SELECT epoch FROM report_series WHERE task=? AND part='train' "
        "AND name='loss' ORDER BY id", (task,))]
    assert epochs == [0, 1, 2, 3, 4]


def test_a_stall_killed_process_exiting_late_leaves_the_next_attempt(
        daemon, tmp_path):
    """The other order: the hung process (an executor whose exit waits
    for a file) outlives the kill until attempt 1 has been requeued and
    dispatched. The row stays ``Failed``/``stall-killed`` until the retry
    pass, and the worker's post-exit verdict never touches attempt 1."""
    session, provider = daemon, TaskProvider(daemon)
    started, release = tmp_path / 'started', tmp_path / 'release'
    (task,) = _submit_code(session, tmp_path, 'hang', {
        'info': {'name': 'hang', 'project': 'p_hang'},
        'executors': {'hang': {'type': 'stall_hang', 'cores': 1,
                               'started': str(started),
                               'release': str(release)}}},
        STALL_HANG)['hang']
    sup, tick, deadline = _stall_ticker(session)
    tick()
    first_msg = provider.by_id(task).queue_id
    consumer = threading.Thread(target=_consume, args=(session, False))
    consumer.start()
    try:
        _wait('the hang', started.exists)
        deadline(1)

        def killed():
            tick()
            return provider.by_id(task).status == int(TaskStatus.Failed)
        _wait('the stall kill', killed, timeout=30)
        deadline(3600)
        row = provider.by_id(task)
        assert (row.failure_reason, row.attempt or 0) == ('stall-killed', 0)

        def requeued():
            tick()
            return provider.by_id(task).status == int(TaskStatus.Queued)
        _wait('attempt 1 dispatched', requeued)
        assert provider.by_id(task).queue_id != first_msg
        release.touch()
        consumer.join(timeout=60)
    finally:
        release.touch()
        consumer.join(timeout=60)
    assert not consumer.is_alive()
    msg = session.query_one('SELECT status, result FROM queue_message '
                            'WHERE id=?', (first_msg,))
    assert tuple(msg) == ('failed', 'subprocess failed (rc=143)')
    row = provider.by_id(task)
    assert (row.status, row.attempt, row.failure_reason) == (
        int(TaskStatus.Queued), 1, 'stall-killed')
    assert _stall_alerts(session) == [
        ('task-stall', task, 'critical', 'open')]
    assert len(_watchdog_lines(session, task)) == 1


def test_a_beating_serve_replica_is_never_stall_killed(tmp_path):
    """A ``serve_replica`` executor on the CPU, in a thread as its
    ``run-task`` runs it, beating every 0.05 s: a watchdog with a 1 s
    deadline, evaluated for 2.5 s, finds no stall; once it stops serving
    (and beating), the next evaluation past the deadline does."""
    import jax
    import numpy as np
    from mlcomp_tpu.models import create_model as jax_create_model
    from mlcomp_tpu.train import export as jax_export
    from mlcomp_tpu_torch.db.migration import migrate
    from tests.test_torch_port_fleet import _executor, _replica_rows
    spec = {'name': 'mlp', 'num_classes': 4, 'hidden': [16]}
    variables = jax_create_model(**spec).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.float32))
    export = jax_export.export_model(
        str(tmp_path / 'mlp'), variables['params'], spec,
        meta={'input_shape': [8], 'input_dtype': 'float32'})
    db = Session.create_session(key=f'replica-{tmp_path}',
                                connection_string=f'sqlite:///{tmp_path}/r.db')
    try:
        migrate(db)
        _, task, info = _replica_rows(db, export)
        ex = _executor(db, task, info, serve={'device': 'cpu'})
        thread = threading.Thread(target=ex.work, daemon=True)
        before = TaskProvider(db).by_id(task.id).last_activity
        thread.start()
        _wait('the first beat', lambda: TaskProvider(db).by_id(
            task.id).last_activity != before)
        wd = Watchdog(db, WatchdogConfig(stall_deadline_s=1,
                                         evaluate_every_s=0))
        t_end = time.monotonic() + 2.5
        while time.monotonic() < t_end:
            assert wd.evaluate() == []
            time.sleep(0.25)
        ex.server.shutdown()
        thread.join(timeout=30)
        time.sleep(1.5)
        assert [(f['rule'], f['task']) for f in wd.evaluate()] == [
            ('task-stall', task.id)]
    finally:
        Session.cleanup(db.key)


# -------------------------------------------- routes, commands, metrics
from tests.test_torch_port_api import (  # noqa: E402 (fixtures reused)
    Twin as ApiTwin, _request, normalise, servers, templates,
)
from tests.test_torch_port_quota import _command_outputs  # noqa: E402

_ = (servers, templates)


@pytest.fixture()
def api_twin(tmp_path, monkeypatch, templates, servers):
    t = ApiTwin(tmp_path, monkeypatch, templates, servers)
    yield t
    t.close()


def _alert_rows(twin):
    """Alerts in both DBs: a critical stall (open, with details), a
    resolved regression, a warning on another task, a task-less SLO
    burn; then each package's SLO engine over the same SLI rows."""
    for i, status in ((1, JaxStatus.Failed), (2, JaxStatus.InProgress)):
        twin.both_sql('INSERT INTO task (id, name, executor, status, '
                      'last_activity) VALUES (?, ?, ?, ?, ?)',
                      (i, f't{i}', 'e', int(status), now()))
    for rule, task, sev, status, details, computer in (
            ('task-stall', 1, 'critical', 'open', {'age_s': 812.5}, 'h1'),
            ('step-regression', 2, 'warning', 'resolved', None, None),
            ('hbm-pressure', 2, 'warning', 'open',
             {'occupancy': 0.8, 'rising': True}, 'h2'),
            ('slo-dispatch-p99', None, 'critical', 'open', None, None)):
        twin.both_sql(
            'INSERT INTO alert (time, rule, severity, task, computer, '
            'message, details, status, resolved_time) VALUES '
            '(?, ?, ?, ?, ?, ?, ?, ?, ?)',
            (now(), rule, sev, task, computer, f'{rule} message',
             json.dumps(details) if details else None, status,
             now() if status == 'resolved' else None))
    at = now()
    for minute in range(60):
        twin.both_sql("INSERT INTO metric (task, name, kind, step, value, "
                      "time, component, tags) VALUES (NULL, "
                      "'slo.dispatch-p99.bad', 'gauge', NULL, 1.0, ?, "
                      "'supervisor', NULL)",
                      (at - datetime.timedelta(minutes=minute),))
    twin.both_sql("INSERT INTO metric (task, name, kind, step, value, time, "
                  "component, tags) VALUES (NULL, 'queue.wait_s.train.p95', "
                  "'histogram', NULL, 12.5, ?, 'supervisor', NULL)", (at,))
    JaxSloEngine(twin.jax).evaluate(now_dt=at)
    SloEngine(twin.port).evaluate(now_dt=at)


def test_slos_route_and_get_mirror_give_jax_payloads(api_twin):
    assert api_twin.ok('/api/slos', token=None) == {'data': []}
    _alert_rows(api_twin)
    body = api_twin.ok('/api/slos', token=None)
    assert body == api_twin.ok('/api/slos', method='GET', token=None)
    assert [(e['key'], e['status']) for e in body['data']] == [
        ('dispatch-p99', 'critical'), ('queue-wait-train', 'ok')]
    assert body['data'][0]['alert']['rule'] == 'slo-dispatch-p99'


@pytest.mark.parametrize('name, flags', [
    ('alerts', []), ('alerts', ['--all']), ('alerts', ['--json']),
    ('alerts', ['--all', '--json']), ('alerts', ['--task', '2']),
    ('alerts', ['--task', '2', '--all']),
    ('alerts', ['--rule', 'task-stall']),
    ('alerts', ['--rule', 'nothing']), ('alerts', ['--resolve', '1']),
    ('alerts', ['--resolve', '2']), ('alerts', ['--resolve', '99']),
    ('slos', []), ('slos', ['--json']),
])
def test_the_commands_print_jaxs_text(api_twin, monkeypatch, capsys, name,
                                      flags):
    _alert_rows(api_twin)
    (their_code, theirs), (code, mine) = _command_outputs(
        api_twin, monkeypatch, capsys, name, flags)
    assert code == their_code
    if '--json' in flags:
        assert normalise(json.loads(mine)) == normalise(json.loads(theirs))
    else:
        assert normalise(mine) == normalise(theirs)
    if flags[:1] == ['--resolve']:
        assert code == (0 if flags[1] == '1' else 1)


def test_empty_alerts_and_scoreboard_print_as_jax(api_twin, monkeypatch,
                                                  capsys):
    for name, flags, want in (
            ('alerts', [], 'no open alerts\n'),
            ('alerts', ['--all'], 'no alerts\n'),
            ('slos', [], 'no SLO objectives evaluated yet (the supervisor '
                         'records them while running)\n')):
        theirs, mine = _command_outputs(api_twin, monkeypatch, capsys, name,
                                        flags)
        assert mine == theirs == (0, want)


def test_the_tick_and_slo_families_give_jax_samples(api_twin, monkeypatch):
    """Each package's builder records one tick into its twin DB (the
    same claimed and pending messages, the same decision trace and
    counter deltas), flushes, and its SLO engine judges the same rows:
    ``/metrics`` of both servers gives the same samples in the families
    these rows feed."""
    from types import SimpleNamespace
    from mlcomp_tpu.telemetry.export import (
        parse_openmetrics as jax_parse,
    )
    from mlcomp_tpu_torch.telemetry.export import parse_openmetrics
    twin = api_twin
    _alert_rows(twin)
    t0 = now() - datetime.timedelta(seconds=300)
    for i, (executor, ttype, prio, waited) in enumerate((
            ('train', 1, None, 40), ('serve_replica', 3, 'high', 4),
            ('train', 1, 'preemptible', 700)), start=10):
        twin.both_sql(
            "INSERT INTO queue_message (id, queue, payload, status, created, "
            "claimed_at, claimed_by) VALUES (?, 'h1_default', '{}', "
            "'claimed', ?, ?, 'h1:0')",
            (i, t0, t0 + datetime.timedelta(seconds=waited)))
        twin.both_sql('INSERT INTO task (id, name, executor, type, status, '
                      'priority, queue_id, last_activity) VALUES '
                      '(?, ?, ?, ?, ?, ?, ?, ?)',
                      (i, f'q{i}', executor, ttype,
                       int(JaxStatus.InProgress), prio, i, now()))
    stats = {'busy': {'retries': 7, 'gave_up': 2}, 'listen': 3, 'fence': 1}
    for core, events, fencing in ((jax_core, jax_events, jax_fencing),
                                  (port_supervisor,) * 3):
        monkeypatch.setattr(core, 'busy_retry_stats',
                            lambda: dict(stats['busy']))
        monkeypatch.setattr(events, 'listener_stats',
                            lambda: {'reconnects': stats['listen']})
        monkeypatch.setattr(fencing, 'fence_rejections',
                            lambda: stats['fence'])
    for sup in (JaxSupervisor(session=twin.jax),
                SupervisorBuilder(session=twin.port)):
        sup._last_claim_ts = t0
        sup._busy_seen, sup._listener_seen, sup._fence_seen = {}, {}, 0
        sup.lease = SimpleNamespace(epoch=2)
        sup.aux = {'duration': 0.5, 'dispatched': [{'task': 10}]}
        sup.record_tick_telemetry()
        sup.telemetry.flush()
    families = []
    for server, parse in ((twin.jax_server, jax_parse),
                          (twin.port_server, parse_openmetrics)):
        status, raw = _request(f'http://127.0.0.1:{server.port}',
                               '/metrics', method='GET', token=None)
        assert status == 200
        families.append(parse(raw.decode()))
    theirs, mine = families
    for name in ('mlcomp_dispatch_latency_seconds',
                 'mlcomp_queue_wait_seconds', 'mlcomp_slo_bad_fraction',
                 'mlcomp_slo_burn_rate', 'mlcomp_db_busy_retries', 'mlcomp_db_listener_reconnects',
                 'mlcomp_alerts_open', 'mlcomp_task_retries',
                 'mlcomp_queue_max_wait_seconds'):
        assert mine[name]['type'] == theirs[name]['type'], name
        assert mine[name]['samples'] == theirs[name]['samples'], name
        if name != 'mlcomp_task_retries':
            assert mine[name]['samples'], name
    waits = {(s[1]['class'], s[1]['priority'], s[1]['le']): s[2]
             for s in mine['mlcomp_queue_wait_seconds']['samples']
             if s[0].endswith('_bucket')}
    assert waits[('train', 'normal', '60.0')] == 1.0
    assert waits[('train', 'preemptible', '600.0')] == 0.0
    assert waits[('serve-replica', 'high', '5.0')] == 1.0
    assert sorted((s[1]['rule'], s[1]['severity'], s[2]) for s in
                  mine['mlcomp_alerts_open']['samples']) == [
        ('hbm-pressure', 'warning', 1.0),
        ('slo-dispatch-p99', 'critical', 1.0),
        ('task-stall', 'critical', 1.0)]


def test_route_auth_and_read_only_lists_match_jax():
    """``/api/slos`` joined the ported routes: each route's auth flag and
    the reads safe to retry after a heal are JAX's, and what still waits
    is the server-proxied DB."""
    import mlcomp_tpu.server.api as jax_api
    import mlcomp_tpu_torch.server.api as api
    assert {r: auth for r, (_, auth) in api._ROUTES.items()} == \
        {r: auth for r, (_, auth) in jax_api._ROUTES.items()}
    assert api._READ_ONLY_ROUTES == jax_api._READ_ONLY_ROUTES
    assert api._ROUTES['/api/slos'] == (api.api_slos, False)
    assert sorted(api.WAITING_ROUTES.items()) == [
        ('/api/db', 'A0: the server-proxied DB, with PostgreSQL'),
        ('/api/db_audit', 'A0: the server-proxied DB, with PostgreSQL'),
        ('/api/worker_token', 'A0: the server-proxied DB, with PostgreSQL')]


def test_the_recorder_keeps_jaxs_lockset_suppression():
    """The JAX package's concurrency rules over the port's recorder: the
    racy ``len()`` of ``_maybe_flush`` carries JAX's justified
    suppression, so ``cc-lockset`` reports nothing there."""
    import inspect
    from mlcomp_tpu.analysis.concurrency import lint_concurrency_source
    import mlcomp_tpu_torch.telemetry.metrics as port_metrics
    source = inspect.getsource(port_metrics)

    def lockset(text):
        return [f.rule for f in lint_concurrency_source(
            text, 'telemetry/metrics.py') if f.rule == 'cc-lockset']
    assert lockset(source) == []
    assert lockset(source.replace('# preflight: disable=cc-lockset',
                                  '#')) == ['cc-lockset']


"""Quotas, checkpoint-preemption and the usage ledger on the port, held
against the JAX package on the CPU.

- the victim planners of ``server/scheduler.py`` against JAX's over
  seeded victim lists and host sets with ties (hypothesis);
- ``QuotaProvider``, ``PreemptionProvider`` and ``UsageProvider``: the
  cases of the JAX package's own provider tests, run on both packages,
  their observations equal (raced folds and records under threads);
- the supervisor tick on twin DBs (``tests/test_torch_port_supervisor.py``
  ``Twin``): quota admission, the preemption engine with its repair and
  its fence, the usage fold; after every tick the task, queue, alert,
  ``preemption`` and ``usage`` rows and the decision trace are JAX's;
- migration v14's backfill of a JAX v13 DB;
- ``/api/usage``, ``/api/quotas``, ``/api/quota/set|delete`` over both
  packages' servers, the ``usage`` and ``quotas`` commands' text, and
  ``mlcomp_quota_usage``;
- a preempted ``run-task`` process whose exit never touches the next
  attempt, and a preempted in-process trainer (``device: cpu``) that
  stops at its epoch boundary and resumes from its last checkpoint.
"""

import datetime
import json
import shutil
import sqlite3
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.enums import TaskStatus as JaxStatus
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.db.models import Task as JaxTask
from mlcomp_tpu.db.providers import (
    MetricProvider as JaxMetrics, QueueProvider as JaxQueue,
    TaskProvider as JaxTasks, UsageProvider as JaxUsage,
)
from mlcomp_tpu.db.providers.quota import (
    PreemptionProvider as JaxPreemptions, QuotaProvider as JaxQuotas,
)
from mlcomp_tpu.recovery import RecoveryConfig as JaxRecovery
from mlcomp_tpu.server import scheduler as jax_policy
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu.utils.misc import now
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import Task
from mlcomp_tpu_torch.db.providers import (
    MetricProvider, PreemptionProvider, QueueProvider, QuotaProvider,
    TaskProvider, UsageProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server import scheduler as policy
from mlcomp_tpu_torch.server.supervisor import SupervisorBuilder

from tests.test_torch_port_supervisor import (
    RECOVERY, Twin, _ago, _dispatched,
)


@pytest.fixture()
def twin(tmp_path):
    t = Twin(tmp_path)
    yield t
    t.close()


# ------------------------------------------------------------ the policy
def _victims(rng, n, first_id=1):
    """``n`` victim dicts with ties: few classes, cores and run times."""
    classes = list(policy.PRIORITY_CLASSES) + ['unknown']
    return [{'task_id': first_id + i,
             'priority': classes[int(rng.integers(len(classes)))],
             'cores': int(rng.integers(0, 4)),
             'run_s': float(rng.choice([0.0, 10.0, 10.0, 35.5, -3.0]))}
            for i in range(n)]


def _ids(victims):
    return None if victims is None else [v['task_id'] for v in victims]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_victim_planners_give_jax_plans(seed):
    rng = np.random.default_rng(seed)
    victims = _victims(rng, int(rng.integers(0, 9)))
    for v in victims:
        assert policy.victim_cost(v) == jax_policy.victim_cost(v)
    assert _ids(policy.victim_order(victims)) == \
        _ids(jax_policy.victim_order(victims))
    for rank in range(5):
        assert _ids(policy.eligible_victims(victims, rank)) == \
            _ids(jax_policy.eligible_victims(victims, rank))
        for need in range(0, 6):
            for free in range(0, 3):
                assert _ids(policy.plan_single_node(
                    need, free, victims, rank)) == _ids(
                    jax_policy.plan_single_node(need, free, victims, rank))
    hosts, next_id = [], 1
    for h in range(int(rng.integers(0, 5))):
        vs = _victims(rng, int(rng.integers(0, 4)), next_id)
        next_id += len(vs)
        hosts.append({'name': f'h{int(rng.integers(0, 3))}{h}',
                      'free': int(rng.integers(0, 3)), 'victims': vs})
    for rank in range(4):
        for need, grain in ((1, 0), (2, 1), (4, 2), (5, 2), (8, 4)):
            plan, used = policy.plan_gang(need, grain, hosts, rank)
            theirs, their_used = jax_policy.plan_gang(need, grain, hosts,
                                                      rank)
            assert used == their_used
            assert (None if plan is None else
                    {k: _ids(v) for k, v in plan.items()}) == \
                (None if theirs is None else
                 {k: _ids(v) for k, v in theirs.items()})
    assert policy.MAX_PREEMPTIONS_PER_TICK == \
        jax_policy.MAX_PREEMPTIONS_PER_TICK == 8


# -------------------------------------------------------------- providers
PACKAGES = {
    'jax': dict(session=JaxSession, migrate=jax_migrate, Task=JaxTask,
                Status=JaxStatus, Tasks=JaxTasks, Queue=JaxQueue,
                Metrics=JaxMetrics, Usage=JaxUsage, Quotas=JaxQuotas,
                Preemptions=JaxPreemptions),
    'port': dict(session=Session, migrate=migrate, Task=Task,
                 Status=TaskStatus, Tasks=TaskProvider, Queue=QueueProvider,
                 Metrics=MetricProvider, Usage=UsageProvider,
                 Quotas=QuotaProvider, Preemptions=PreemptionProvider),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, tmp_path):
    """One package's classes and a migrated DB of its own."""
    p = dict(PACKAGES[request.param], name=request.param,
             url=f'sqlite:///{tmp_path}/{request.param}.db')
    p['db'] = p['session'].create_session(key=f'prov-{tmp_path}',
                                          connection_string=p['url'])
    p['migrate'](p['db'])
    yield p
    p['session'].cleanup(p['db'].key)


def _terminal(p, owner='alice', project='proj', seconds=50.0,
              cores='[0, 1]', attempt=0, **extra):
    finished = now()
    task = p['Task'](name='billed', executor='train',
                     status=int(p['Status'].Success),
                     started=finished - datetime.timedelta(seconds=seconds),
                     finished=finished, cores_assigned=cores, owner=owner,
                     project=project, attempt=attempt, last_activity=now(),
                     **extra)
    p['Tasks'](p['db']).add(task)
    return task


def _busy(p, name, cores_list, owner=None, **extra):
    task = p['Task'](name=name, executor='noop', cores=len(cores_list),
                     cores_max=len(cores_list),
                     status=int(p['Status'].InProgress), owner=owner,
                     computer_assigned='h1',
                     cores_assigned=json.dumps(cores_list),
                     last_activity=now(), started=now(), **extra)
    p['Tasks'](p['db']).add(task)
    return task


def _quota_script(p) -> list:
    """tests/test_scheduler.py's quota cases; each observation kept."""
    qp, out = p['Quotas'](p['db']), []
    out.append(qp.limit_for('owner', 'nobody', 'cores'))
    q = qp.set_quota('owner', 'alice', 'cores', 4)
    out.append((q.scope, q.tenant, q.resource, q.limit_value, q.window_s))
    q = qp.set_quota('owner', 'alice', 'cores', 8, window_s=60.0)
    out.append((q.limit_value, q.window_s))
    qp.set_quota('owner', 'mallory', 'cores', 0)
    qp.set_quota('project', 'nlp', 'core_seconds', 86400)
    out.append([qp.limit_for('owner', t, 'cores')
                for t in ('alice', 'mallory', 'bob')])
    for args in (('team', 'x', 'cores', 1), ('owner', 'x', 'gpus', 1),
                 ('owner', 'x', 'cores', 'lots')):
        with pytest.raises(ValueError) as err:
            qp.set_quota(*args)
        out.append(str(err.value))
    for args in (('live_cores', 'team'), ('window_core_seconds', 'x')):
        with pytest.raises(ValueError) as err:
            getattr(qp, args[0])(args[1])
        out.append(str(err.value))
    out.append([(q.scope, q.tenant, q.resource, q.limit_value)
                for q in qp.all()])
    out.append(qp.get('owner', 'alice', 'cores').limit_value)
    out.append([qp.delete('owner', 'alice', 'cores'),
                qp.delete('owner', 'alice', 'cores'),
                qp.get('owner', 'alice', 'cores')])
    return out


def test_quota_provider_gives_jax_results(tmp_path):
    results = []
    for name in sorted(PACKAGES):
        p = dict(PACKAGES[name], url=f'sqlite:///{tmp_path}/{name}.db')
        p['db'] = p['session'].create_session(
            key=f'quota-{tmp_path}-{name}', connection_string=p['url'])
        try:
            p['migrate'](p['db'])
            results.append(_quota_script(p))
        finally:
            p['session'].cleanup(p['db'].key)
    assert results[0] == results[1]
    assert results[1][3] == [8.0, 0.0, None]
    assert 'got' in results[1][4] and results[1][-1] == [True, False, None]


def test_live_cores_skip_a_fanned_out_gang_parent(pkg):
    qp = pkg['Quotas'](pkg['db'])
    _busy(pkg, 'solo', [0, 1], owner='alice')
    parent = pkg['Task'](name='gang', executor='noop', cores=4, cores_max=4,
                         owner='bob', status=int(pkg['Status'].Queued),
                         last_activity=now())
    pkg['Tasks'](pkg['db']).add(parent)
    child = _busy(pkg, 'rank0', [2, 3, 4, 5], owner='bob')
    child.parent = parent.id
    pkg['Tasks'](pkg['db']).update(child, ['parent'])
    _busy(pkg, 'unlabelled', [6], project='nlp')
    assert qp.live_cores('owner') == {'alice': 2, 'bob': 4, 'default': 1}
    assert qp.live_cores('project') == {'default': 6, 'nlp': 1}


@pytest.mark.parametrize('window_s, want', [
    (3600.0, {'alice': 100.0, 'bob': 50.0}),
    (7300.0, {'alice': 1000.0, 'bob': 50.0}),
])
def test_window_core_seconds_across_the_window_edge(pkg, window_s, want):
    old = now() - datetime.timedelta(seconds=7200)
    for tid, owner, cs, finished in ((1, 'alice', 100.0, now()),
                                     (2, 'alice', 900.0, old),
                                     (3, 'bob', 50.0, now())):
        pkg['db'].execute(
            'INSERT INTO usage (task, attempt, owner, core_seconds, '
            'finished, created) VALUES (?, 0, ?, ?, ?, ?)',
            (tid, owner, cs, finished, finished))
    assert pkg['Quotas'](pkg['db']).window_core_seconds(
        'owner', window_s=window_s) == want


def _raced(pkg, key, fn):
    """``fn(session)`` on two threads, each on a connection of its own,
    released together; their results."""
    barrier, results = threading.Barrier(2), [None, None]

    def run(i):
        s = pkg['session'].create_session(key=f'{key}-{i}',
                                          connection_string=pkg['url'])
        try:
            barrier.wait()
            results[i] = fn(s)
        finally:
            pkg['session'].cleanup(s.key)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results


def test_a_preemption_is_recorded_once_under_two_threads(pkg):
    victim = _busy(pkg, 'v', [0])
    boss = pkg['Task'](name='b', executor='noop', priority='high',
                       status=int(pkg['Status'].NotRan),
                       last_activity=now())
    pkg['Tasks'](pkg['db']).add(boss)
    got = _raced(pkg, f'rec-{pkg["url"]}', lambda s: pkg['Preemptions'](
        s).record(victim, boss, 'capacity', 1, epoch=1,
                  victim_class='preemptible', initiator_class='high'))
    assert sorted(got) == [False, True]
    pp = pkg['Preemptions'](pkg['db'])
    assert pp.count() == 1
    (row,) = pp.unapplied()
    assert (row.task, row.attempt, row.initiator, row.victim_class,
            row.initiator_class, row.reason, row.computer, row.cores_freed,
            row.applied, row.epoch) == (victim.id, 0, boss.id, 'preemptible',
                                        'high', 'capacity', 'h1', 1, 0, 1)
    with pytest.raises(sqlite3.IntegrityError):
        pkg['db'].execute('INSERT INTO preemption (task, attempt, applied, '
                          'time) VALUES (?, 0, 0, ?)', (victim.id, now()))
    assert [pp.mark_applied(victim.id, 0), pp.mark_applied(victim.id, 0)] \
        == [True, False]
    assert pp.unapplied() == [] and len(pp.for_task(victim.id)) == 1
    victim.attempt = 1          # a new attempt is a new decision
    assert pp.record(victim, boss, 'capacity', 1, epoch=1) is True
    assert [p.attempt for p in pp.recent()] == [1, 0]


def _usage_rows(session):
    """The ledger's rows, write times aside; each package stamps a
    claim with its own clock, so seconds are held to 1 ms."""
    return [tuple(round(v, 3) if isinstance(v, float) else v
                  for k, v in dict(r).items()
                  if k not in ('id', 'created', 'started', 'finished'))
            for r in session.query('SELECT * FROM usage ORDER BY id')]


def _usage_script(p) -> list:
    """tests/test_usage_slo.py's fold cases; each observation kept."""
    up, out = p['Usage'](p['db']), []
    first = _terminal(p, seconds=50.0)
    pending = up.unfolded_terminal_tasks()
    out.append([t.id for t in pending])
    # the raced double fold: one wins
    out.append(sorted(_raced(p, f'fold-{p["url"]}',
                             lambda s: p['Usage'](s).fold_task(pending[0]))))
    out.append((up.count(), up.unfolded_terminal_tasks()))
    # a new attempt is a new row
    first.attempt = 1
    p['Tasks'](p['db']).update(first, ['attempt'])
    out.append([up.fold_task(t) for t in up.unfolded_terminal_tasks()])
    # queue wait: 30 s from a claimed message; None without a claim
    qp = p['Queue'](p['db'])
    claimed = qp.enqueue('q_train', {'action': 'execute'})
    p['db'].execute('UPDATE queue_message SET created=? WHERE id=?',
                    (now() - datetime.timedelta(seconds=30), claimed))
    assert qp.claim(['q_train'], 'w1') is not None
    waited = _terminal(p, owner='bob', cores='[0]', seconds=200.0,
                       queue_id=claimed)
    unclaimed = qp.enqueue('q_other', {'action': 'execute'})
    never = _terminal(p, owner='carol', cores='not json',
                      queue_id=unclaimed)
    out.append((round(up.queue_wait(waited)), up.queue_wait(never),
                up.queue_wait(first)))
    # peak HBM over device*.hbm_used
    p['Metrics'](p['db']).add_many([
        (waited.id, 'device0.hbm_used', 'gauge', 1, 1.5e9, now(), 'train',
         None),
        (waited.id, 'device1.hbm_used', 'gauge', 1, 2.5e9, now(), 'train',
         None),
        (waited.id, 'device0.hbm_limit', 'gauge', 1, 8e10, now(), 'train',
         None)])
    out.append((up.hbm_peak(waited.id), up.hbm_peak(never.id)))
    out.append([up.fold_task(t) for t in up.unfolded_terminal_tasks()])
    for key in ('owner', 'project', 'task_class', 'computer'):
        out.append([{k: (round(v) if isinstance(v, float) else v)
                     for k, v in r.items()} for r in up.aggregate(key)])
    with pytest.raises(ValueError) as err:
        up.aggregate('owner; DROP TABLE usage')
    out.append(str(err.value))
    out.append([(r.task, r.attempt, r.owner) for r in up.recent(
        limit=10, owner='alice')])
    out.append(_usage_rows(p['db']))
    return out


def test_usage_provider_gives_jax_results(tmp_path):
    results = []
    for name in sorted(PACKAGES):
        p = dict(PACKAGES[name], url=f'sqlite:///{tmp_path}/{name}.db')
        p['db'] = p['session'].create_session(
            key=f'usage-{tmp_path}-{name}', connection_string=p['url'])
        try:
            p['migrate'](p['db'])
            results.append(_usage_script(p))
        finally:
            p['session'].cleanup(p['db'].key)
    mine, theirs = results[1], results[0]
    assert mine == theirs
    assert mine[1] == [False, True] and mine[3] == [True]
    assert mine[4] == (30, None, None)
    assert mine[5] == (2.5e9, None)


# ------------------------------------------------------------- the tick
def _quota(twin, scope, tenant, resource, limit, window_s=None):
    JaxQuotas(twin.jax).set_quota(scope, tenant, resource, limit,
                                  window_s=window_s)


def _ledger(twin, task, owner, core_seconds, project='p', hours_ago=0.0):
    finished = _ago(3600 * hours_ago)
    twin.jax.execute(
        'INSERT INTO usage (task, attempt, owner, project, core_seconds, '
        'finished, created) VALUES (?, 0, ?, ?, ?, ?, ?)',
        (task, owner, project, core_seconds, finished, finished))


def _busy_twin(twin, name, cores, priority=None, **fields):
    """An InProgress row on host1 holding ``cores`` (a list)."""
    return twin.task(name, status=JaxStatus.InProgress, cores=len(cores),
                     priority=priority, computer_assigned='host1',
                     cores_assigned=json.dumps(cores), started=_ago(60),
                     **fields)


def test_quota_admission_refuses_at_the_ceiling_critical_exempt(twin):
    twin.computer('host1', cores=8)
    _quota(twin, 'owner', 'alice', 'cores', 2)
    _quota(twin, 'project', 'nlp', 'core_seconds', 100, window_s=3600)
    _ledger(twin, 900, 'carol', 150.0, project='nlp')
    _busy_twin(twin, 'held', [0, 1], owner='alice')
    over = twin.task('over', cores=2, owner='alice')
    fine = twin.task('fine', cores=2, owner='bob')
    pager = twin.task('pager', cores=2, owner='alice', priority='critical')
    spent = twin.task('spent', cores=1, owner='dave', project='nlp')
    twin.start()
    st = twin.tick()
    assert set(_dispatched(st)) == {fine, pager}
    blocked = st['aux']['not_placed']
    # the critical task dispatched first and was billed in the same tick
    assert blocked[str(over)] == {
        'quota': 'quota: owner alice holds 4/2 cores, +2 would exceed'}
    assert blocked[str(spent)] == {
        'quota': 'quota: project nlp used 150/100 core-seconds in window'}


def test_a_failed_quota_read_admits_every_tenant(twin, monkeypatch):
    """A snapshot that cannot read the quota table degrades to every
    tenant unlimited in both packages: quota never stops scheduling."""
    from mlcomp_tpu.db.providers import quota as jax_quota
    from mlcomp_tpu_torch.db.providers import quota as port_quota

    def broken(self):
        raise sqlite3.OperationalError('no such table: quota')

    twin.computer('host1', cores=4)
    _quota(twin, 'owner', 'alice', 'cores', 0)
    locked = twin.task('locked', owner='alice')
    twin.start()
    for module in (jax_quota, port_quota):
        monkeypatch.setattr(module.QuotaProvider, 'all', broken)
    st = twin.tick()
    assert _dispatched(st) == {locked: [0]}


def test_a_same_tick_burst_cannot_leak_past_the_ceiling(twin):
    twin.computer('host1', cores=8)
    _quota(twin, 'owner', 'alice', 'cores', 2)
    first = twin.task('a1', cores=2, owner='alice')
    second = twin.task('a2', cores=2, owner='alice')
    twin.start()
    st = twin.tick()
    assert set(_dispatched(st)) == {first}
    assert 'quota' in st['aux']['not_placed'][str(second)]


def test_fair_share_orders_equals_by_windowed_usage(twin):
    twin.computer('host1', cores=1)
    for owner in ('heavy', 'light'):
        _quota(twin, 'owner', owner, 'core_seconds', 1000)
    _ledger(twin, 901, 'heavy', 900.0)
    _ledger(twin, 902, 'light', 100.0)
    _ledger(twin, 903, 'light', 5000.0, hours_ago=30)   # outside the day
    heavy = twin.task('heavy_job', owner='heavy')
    light = twin.task('light_job', owner='light')
    twin.start()
    st = twin.tick()
    assert st['aux']['tasks_to_process'] == [light, heavy]
    assert set(_dispatched(st)) == {light}


def test_a_full_pool_evicts_a_lower_class(twin):
    twin.computer('host1', cores=2)
    victim = _busy_twin(twin, 'cell', [0, 1], additional_info='sweep: 1\n')
    boss = twin.task('replica', cores=2, priority='high')
    twin.start()
    st = twin.tick()
    assert st['aux']['preempted'] == [
        {'task': victim, 'attempt': 0, 'class': 'preemptible',
         'reason': 'capacity', 'repair': False}]
    (row,) = twin.port.query('SELECT * FROM preemption')
    assert (row['task'], row['initiator'], row['applied'],
            row['victim_class'], row['initiator_class'],
            row['cores_freed']) == (victim, boss, 1, 'preemptible', 'high',
                                    2)
    metric = twin.port.query_one(
        "SELECT * FROM metric WHERE name='scheduler.preemption'")
    assert json.loads(metric['tags']) == {
        'class': 'preemptible', 'reason': 'capacity', 'repair': 0}
    st = twin.tick()
    assert _dispatched(st) == {boss: [0, 1]}


def test_an_equal_class_is_never_evicted(twin):
    twin.computer('host1', cores=2)
    _busy_twin(twin, 'peer', [0, 1], priority='high')
    twin.task('replica', cores=2, priority='high')
    twin.start()
    st = twin.tick()
    assert st['preemptions'] == [] and st['aux']['preempted'] is None


def test_an_aged_preemptible_blocker_evicts_nobody(twin):
    twin.computer('host1', cores=2)
    _busy_twin(twin, 'running', [0, 1], additional_info='sweep: 1\n')
    stale = twin.task('starved', cores=2, additional_info='sweep: 2\n',
                      waited=50 * policy.AGING_STEP_S)
    twin.start()
    st = twin.tick()
    assert st['preemptions'] == []
    assert st['aux']['tasks_to_process'] == [stale]


def test_the_budget_bounds_evictions_a_tick(twin):
    n = policy.MAX_PREEMPTIONS_PER_TICK + 4
    twin.computer('host1', cores=n)
    cells = [_busy_twin(twin, f'cell{i}', [i], additional_info='sweep: 1\n')
             for i in range(n)]
    twin.task('big', cores=n, priority='critical')
    twin.start()
    st = twin.tick()
    evicted = [p['task'] for p in st['aux']['preempted']]
    # equal cost: the youngest rows go first
    assert evicted == cells[::-1][:policy.MAX_PREEMPTIONS_PER_TICK]
    st = twin.tick()
    assert len(st['preemptions']) == n


def test_a_blocked_gang_over_several_computers_evicts_nobody(twin):
    """Where JAX's engine would evict for a gang that needs the
    multi-host fan-out, the port refuses (A4) before any decision row:
    it never evicts for an ask it cannot place."""
    victims = []
    for host in ('host1', 'host2'):
        twin.computer(host, cores=1)
        victims.append(twin.task(
            f'cell_{host}', status=JaxStatus.InProgress,
            computer_assigned=host, cores_assigned='[0]', started=_ago(60),
            additional_info='sweep: 1\n'))
    gang = twin.task('gang', cores=2, cores_max=2, single_node=False,
                     priority='high')
    twin.start()
    twin.jax_sup.build()
    assert [(r['task'], r['reason']) for r in twin.jax.query(
        'SELECT * FROM preemption ORDER BY id')] == [
        (v, 'defrag') for v in victims]
    twin.port_sup.build()
    assert twin.port.query('SELECT * FROM preemption') == []
    rows = {r['id']: r['status'] for r in twin.port.query(
        'SELECT id, status FROM task')}
    assert rows == {**{v: int(TaskStatus.InProgress) for v in victims},
                    gang: int(TaskStatus.NotRan)}
    (blocked,) = twin.port_sup._capacity_blocked
    assert blocked['multi'] and blocked['task'].id == gang
    with pytest.raises(NotImplementedError, match='A4'):
        twin.port_sup._plan_for(blocked, 2, {}, set())


def _faults(points):
    from mlcomp_tpu.testing import faults as jax_faults
    from mlcomp_tpu_torch.testing import faults
    for module in (jax_faults, faults):
        if points:
            module.configure_faults(points)
        else:
            module.clear_faults()


def _new_leaders(twin):
    """Fresh builders on the same DBs: the standby after a failover."""
    twin.jax_sup = JaxSupervisor(
        session=twin.jax, recovery_config=JaxRecovery(**RECOVERY))
    twin.port_sup = SupervisorBuilder(
        session=twin.port, recovery_config=RecoveryConfig(**RECOVERY))


def test_a_leader_killed_at_the_preempt_seam_is_repaired_once(twin):
    twin.computer('host1', cores=2)
    victim = _busy_twin(twin, 'cell', [0, 1], additional_info='sweep: 1\n')
    boss = twin.task('replica', cores=2, priority='high')
    twin.start()
    _faults({'supervisor.preempt': {'action': 'raise', 'after': 1,
                                    'times': 1}})
    try:
        st = twin.tick()
    finally:
        _faults(None)
    (row,) = st['preemptions']
    assert st['tasks'][0][2] == int(TaskStatus.InProgress)
    assert st['aux']['preempted'] is None
    _new_leaders(twin)
    st = twin.tick()
    assert [(p['task'], p['repair']) for p in st['aux']['preempted']] == [
        (victim, True)]
    assert st['tasks'][0][2:7:4] == (int(TaskStatus.Failed), 'preempted')
    assert twin.port.query_one('SELECT applied FROM preemption')[0] == 1
    st = twin.tick()
    assert len(st['preemptions']) == 1 and _dispatched(st) == {boss: [0, 1]}


def test_a_stale_decision_is_closed_without_a_second_kill(twin):
    twin.computer('host1', cores=4)
    victim = _busy_twin(twin, 'cell', [0], additional_info='sweep: 1\n')
    boss = twin.task('replica', priority='high')
    rows = JaxTasks(twin.jax)
    assert JaxPreemptions(twin.jax).record(
        rows.by_id(victim), rows.by_id(boss), 'capacity', 1, epoch=1)
    twin.jax.execute('UPDATE task SET attempt=1 WHERE id=?', (victim,))
    twin.start()
    st = twin.tick()
    assert twin.port.query_one('SELECT applied FROM preemption')[0] == 1
    assert st['tasks'][0][2:7:4] == (int(TaskStatus.InProgress), None)
    assert st['aux']['preempted'] is None and boss in _dispatched(st)


def test_a_zombie_leaders_preemption_is_fenced_off(twin):
    from mlcomp_tpu.db.fencing import FenceLostError as JaxFenceLost
    from mlcomp_tpu.server.ha import StaticLease as JaxStaticLease
    from mlcomp_tpu_torch.db.fencing import FenceLostError
    from mlcomp_tpu_torch.server.ha import StaticLease
    twin.computer('host1', cores=1)
    _busy_twin(twin, 'victim', [0], priority='preemptible')
    twin.task('blocked', priority='high')
    twin.jax.execute('UPDATE supervisor_lease SET epoch=5, holder=? '
                     'WHERE id=1', ('live:leader:xyz',))
    twin.start()
    with pytest.raises(JaxFenceLost):
        JaxSupervisor(session=twin.jax, lease=JaxStaticLease(3)).build()
    with pytest.raises(FenceLostError):
        SupervisorBuilder(session=twin.port, lease=StaticLease(3)).build()
    for session in (twin.jax, twin.port):
        assert session.query('SELECT * FROM preemption') == []
        assert [r['status'] for r in session.query(
            'SELECT status FROM task ORDER BY id')] == [
            int(TaskStatus.InProgress), int(TaskStatus.NotRan)]


def test_the_victim_is_billed_in_the_tick_that_evicts_it(twin):
    """The preemption tick folds the victim's attempt 0 before the retry
    pass resets its row; the retried attempt and the initiator are
    billed as they finish: three ledger rows, JAX's."""
    twin.computer('host1', cores=1)
    victim = _busy_twin(twin, 'victim', [0], priority='preemptible',
                        owner='alice')
    msg = twin.message(victim, 'host1_default', status='claimed',
                       claimed_by='host1:0', created=_ago(90),
                       claimed_at=_ago(75))
    boss = twin.task('boss', priority='high', owner='bob')
    twin.start()
    st = twin.tick()
    assert st['aux']['usage_folded'] == 1
    (row,) = twin.port.query('SELECT * FROM usage')
    assert (row['task'], row['attempt'], row['status'], row['owner'],
            row['cores'], row['queue_wait_s']) == (
        victim, 0, int(TaskStatus.Failed), 'alice', 1,
        pytest.approx(15.0, abs=0.01))
    assert row['core_seconds'] == pytest.approx(60.0, abs=5.0)
    # a claimed message is the worker's: revoke leaves it as it is
    assert twin.port.query_one('SELECT status FROM queue_message WHERE '
                               'id=?', (msg,))[0] == 'claimed'
    st = twin.tick()                        # the initiator placed
    assert _dispatched(st) == {boss: [0]}
    twin.both('UPDATE task SET next_retry_at=? WHERE id=?',
              (_ago(1), victim))
    st = twin.tick()                        # the retry: attempt 1 waits
    assert [r['task'] for r in st['aux']['retried']] == [victim]
    twin.both('UPDATE task SET status=?, started=?, finished=? WHERE id=?',
              (int(TaskStatus.Success), _ago(50), _ago(20), boss))
    st = twin.tick()
    assert _dispatched(st) == {victim: [0]}
    twin.both('UPDATE task SET status=?, started=?, finished=? WHERE id=?',
              (int(TaskStatus.Success), _ago(10), _ago(0), victim))
    st = twin.tick()
    assert [(r['task'], r['attempt'], r['status']) for r in
            twin.port.query('SELECT * FROM usage ORDER BY id')] == [
        (victim, 0, int(TaskStatus.Failed)),
        (boss, 0, int(TaskStatus.Success)),
        (victim, 1, int(TaskStatus.Success))]
    assert twin.port.query_one('SELECT COUNT(*) FROM preemption')[0] == 1


# ------------------------------------------------------------- migration
def test_v13_db_migrated_by_the_port_gets_jaxs_ledger(tmp_path):
    """A JAX v13 deployment with terminal history: migrated by each
    package, the two files hold the same ``usage`` rows (write times
    aside), and a second migrate folds nothing more."""
    from mlcomp_tpu.db.migration import MIGRATIONS
    key = f'v13-{tmp_path}'
    s = JaxSession.create_session(
        key=key, connection_string=f'sqlite:///{tmp_path}/v13.db')
    s.execute('CREATE TABLE IF NOT EXISTS migration_version '
              '(version INTEGER)')
    for i, fn in enumerate(MIGRATIONS[:13], start=1):
        fn(s)
        s.execute('INSERT INTO migration_version (version) VALUES (?)', (i,))
    s.execute('DROP TABLE usage')
    msg = JaxQueue(s).enqueue('h_default', {'action': 'execute'})
    s.execute('UPDATE queue_message SET created=?, claimed_at=? WHERE id=?',
              (_ago(100), _ago(88), msg))
    done = now()
    rows = [
        ('legacy', int(JaxStatus.Success), _ago(60), done, '[0, 1, 2, 3]',
         None, 0, None),
        ('failed', int(JaxStatus.Failed), _ago(30), done, '[1]', msg, 2,
         'h1'),
        ('skipped', int(JaxStatus.Skipped), None, None, None, None, 0, None),
        ('running', int(JaxStatus.InProgress), _ago(5), None, '[0]', None,
         0, 'h1'),
        ('stopped', int(JaxStatus.Stopped), _ago(9), done, 'bad', None, 1,
         None)]
    for name, status, started, finished, cores, queue_id, attempt, comp \
            in rows:
        s.execute(
            'INSERT INTO task ("name", "executor", "status", "started", '
            '"finished", "cores_assigned", "queue_id", "attempt", '
            '"computer_assigned", "cores", "last_activity") '
            'VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, 2, ?)',
            (name, 'train', status, started, finished, cores, queue_id,
             attempt, comp, now()))
    s.execute("INSERT INTO metric (task, name, kind, value, time) VALUES "
              "(2, 'device0.hbm_used', 'gauge', 3e9, ?)", (now(),))
    JaxSession.cleanup(key)
    shutil.copy(tmp_path / 'v13.db', tmp_path / 'port.db')
    ledgers = []
    for session_cls, do_migrate, db in ((JaxSession, jax_migrate, 'v13.db'),
                                        (Session, migrate, 'port.db')):
        s = session_cls.create_session(
            key=key, connection_string=f'sqlite:///{tmp_path}/{db}')
        try:
            assert do_migrate(s) == 15
            ledgers.append(_usage_rows(s))
            assert do_migrate(s) == 15
            assert _usage_rows(s) == ledgers[-1]
        finally:
            session_cls.cleanup(key)
    assert ledgers[1] == ledgers[0]
    assert [(r[0], r[1], r[3], r[7], r[8], r[9], r[10]) for r in
            ledgers[1]] == [
        (1, 0, 'default', 4, 240.0, None, None),
        (2, 2, 'default', 1, 30.0, 12.0, 3e9),
        (3, 0, 'default', 2, None, None, None),
        (5, 1, 'default', 2, 18.0, None, None)]


# -------------------------------------------- routes, commands, metrics
from tests.test_torch_port_api import (  # noqa: E402 (fixtures reused)
    Twin as ApiTwin, _request, servers, templates,
)

_ = (servers, templates)


@pytest.fixture()
def api_twin(tmp_path, monkeypatch, templates, servers):
    t = ApiTwin(tmp_path, monkeypatch, templates, servers)
    yield t
    t.close()


def _tenant_rows(twin):
    """Tasks in every class and state, ledger rows over three tenants,
    two quotas and two preemptions, in both DBs."""
    tasks = [
        ('a_run', JaxStatus.InProgress, 'alice', 'nlp', None, None, '[0, 1]'),
        ('a_wait', JaxStatus.NotRan, 'alice', 'nlp', 'high', None, None),
        ('b_cell', JaxStatus.Queued, 'bob', 'cv', None, 'sweep: 1\n', '[2]'),
        ('c_replica', JaxStatus.InProgress, 'carol', 'cv', None, None,
         '[3]'),
        ('done', JaxStatus.Success, 'bob', 'cv', 'critical', None, '[4]')]
    for i, (name, status, owner, project, prio, info, cores) in \
            enumerate(tasks, start=1):
        twin.both_sql(
            'INSERT INTO task (id, name, executor, status, owner, project, '
            'priority, additional_info, cores_assigned, cores, '
            'computer_assigned, last_activity) VALUES '
            '(?, ?, ?, ?, ?, ?, ?, ?, ?, 1, ?, ?)',
            (100 + i, name, 'serve_replica' if 'replica' in name else 't',
             int(status), owner, project, prio, info, cores,
             'h1' if cores else None, now()))
    for i, (owner, project, cls, comp, cs, wait, hbm, status) in enumerate([
            ('alice', 'nlp', 'train', 'h1', 120.5, 3.25, 2e9, 6),
            ('alice', 'cv', 'sweep', 'h2', 10.0, None, None, 3),
            ('bob', 'cv', 'train', 'h1', 500.0, 12.5, 7e9, 6),
            ('carol', None, 'serve-replica', None, None, 0.5, 1e9, 4)],
            start=1):
        twin.both_sql(
            'INSERT INTO usage (task, attempt, dag, owner, project, '
            'task_class, computer, cores, core_seconds, queue_wait_s, '
            'hbm_peak_bytes, started, finished, status, created) VALUES '
            '(?, 0, 1, ?, ?, ?, ?, 2, ?, ?, ?, ?, ?, ?, ?)',
            (i, owner, project, cls, comp, cs, wait, hbm, _ago(400),
             _ago(100), status, now()))
    twin.both_sql("INSERT INTO quota (scope, tenant, resource, limit_value, "
                  "window_s, created, updated) VALUES "
                  "('owner', 'alice', 'cores', 4, 86400, ?, ?)",
                  (now(), now()))
    twin.both_sql("INSERT INTO quota (scope, tenant, resource, limit_value, "
                  "window_s, created, updated) VALUES "
                  "('project', 'cv', 'core_seconds', 600, 3600, ?, ?)",
                  (now(), now()))
    for task, attempt, applied in ((103, 0, 1), (103, 1, 0)):
        twin.both_sql(
            'INSERT INTO preemption (task, attempt, victim_class, '
            'initiator, initiator_class, reason, computer, cores_freed, '
            'applied, epoch, time) VALUES (?, ?, ?, 102, ?, ?, ?, 1, ?, '
            '1, ?)', (task, attempt, 'preemptible', 'high', 'capacity',
                      'h1', applied, now()))


def test_usage_route_gives_jax_payloads(api_twin):
    twin = api_twin
    assert twin.ok('/api/usage', token=None)['data']['totals'] == []
    _tenant_rows(twin)
    for group_by in ('owner', 'project', 'task_class', 'computer'):
        body = twin.ok('/api/usage', {'group_by': group_by}, token=None)
        assert body['data']['count'] == 4
        assert body == twin.ok(f'/api/usage?group_by={group_by}',
                               method='GET', token=None)
    body = twin.ok('/api/usage', {'owner': 'alice', 'limit': 1})
    assert [(r['owner'], r['task']) for r in body['data']['recent']] == [
        ('alice', 2)]
    body = twin.ok('/api/usage?project=cv', method='GET', token=None)
    assert {r['project'] for r in body['data']['recent']} == {'cv'}
    assert body['data']['totals'][0]['key'] == 'bob'
    assert twin.call('/api/usage', {'group_by': 'owner; DROP'})[0] != 200
    assert twin.call('/api/usage', {'limit': 'x'})[0] == 400


def test_quota_routes_give_jax_payloads_and_statuses(api_twin):
    twin = api_twin
    _tenant_rows(twin)
    body = twin.ok('/api/quotas', token=None)
    assert [(q['tenant'], q['used'], q['limit']) for q in
            body['data']['quotas']] == [('alice', 2.0, 4.0),
                                        ('cv', 510.0, 600.0)]
    assert body['data']['classes'] == {
        'critical': {'pending': 0, 'running': 0},
        'high': {'pending': 1, 'running': 1},
        'normal': {'pending': 0, 'running': 1},
        'preemptible': {'pending': 0, 'running': 1}}
    assert [(p['task_name'], p['initiator_name'], p['applied'])
            for p in body['data']['preemptions']] == [
        ('b_cell', 'a_wait', False), ('b_cell', 'a_wait', True)]
    assert len(twin.ok('/api/quotas', {'limit': 1})['data'][
        'preemptions']) == 1
    for data, status in (
            ({'scope': 'owner', 'tenant': 'zed', 'resource': 'cores',
              'limit': 3}, 200),
            ({'scope': 'owner', 'tenant': 'zed', 'resource': 'cores',
              'limit': 5, 'window_s': 60}, 200),
            ({'scope': 'project', 'tenant': 'nlp',
              'resource': 'core_seconds', 'limit': '86400'}, 200),
            ({'tenant': 'zed', 'resource': 'cores', 'limit': 1}, 400),
            ({'scope': 'owner', 'tenant': 'zed', 'resource': 'cores'}, 400),
            ({'scope': 'team', 'tenant': 'zed', 'resource': 'cores',
              'limit': 1}, 400),
            ({'scope': 'owner', 'tenant': 'zed', 'resource': 'gpus',
              'limit': 1}, 400),
            ({'scope': 'owner', 'tenant': 'zed', 'resource': 'cores',
              'limit': 'lots'}, 400)):
        got, body = twin.call('/api/quota/set', data)
        assert got == status, (data, body)
        if status == 400:
            theirs = _request(f'http://127.0.0.1:{twin.jax_server.port}',
                              '/api/quota/set', data)[1]
            assert body['reason'] == theirs['reason']
        assert twin.call('/api/quota/set', data, token='bad')[0] == 401
    assert twin.ok('/api/quotas')['data']['quotas'][-1] == {
        'scope': 'project', 'tenant': 'nlp', 'resource': 'core_seconds',
        'limit': 86400.0, 'window_s': 86400.0, 'used': 120.5}
    key = {'scope': 'owner', 'tenant': 'zed', 'resource': 'cores'}
    assert twin.call('/api/quota/delete', key, token='bad')[0] == 401
    assert twin.ok('/api/quota/delete', key) == {'success': True}
    assert twin.call('/api/quota/delete', key)[0] == 404
    assert twin.call('/api/quota/delete', {'scope': 'owner'})[0] == 400
    assert len(twin.ok('/api/quotas')['data']['quotas']) == 3


def test_quota_usage_family_gives_jax_samples(api_twin):
    from mlcomp_tpu.telemetry.export import (
        parse_openmetrics as jax_parse,
    )
    from mlcomp_tpu_torch.telemetry.export import parse_openmetrics
    twin = api_twin
    _tenant_rows(twin)
    families = []
    for server, parse in ((twin.jax_server, jax_parse),
                          (twin.port_server, parse_openmetrics)):
        status, raw = _request(f'http://127.0.0.1:{server.port}',
                               '/metrics', method='GET', token=None)
        assert status == 200
        families.append(parse(raw.decode()))
    theirs, mine = families
    for name in ('mlcomp_quota_usage', 'mlcomp_preemptions',
                 'mlcomp_usage_core_seconds', 'mlcomp_usage_tasks'):
        assert mine[name]['samples'] == theirs[name]['samples'], name
        assert mine[name]['type'] == theirs[name]['type'], name
    assert sorted((s[1]['tenant'], s[1]['kind'], s[2]) for s in
                  mine['mlcomp_quota_usage']['samples']) == [
        ('alice', 'limit', 4.0), ('alice', 'used', 2.0),
        ('cv', 'limit', 600.0), ('cv', 'used', 510.0)]
    errors = {s[1]['collector']: s[2] for s in
              mine['mlcomp_scrape_errors']['samples']}
    assert errors['quota'] == 0


def _command_outputs(twin, monkeypatch, capsys, name, flags):
    """(JAX's exit code and output, the port's) of one command on the
    twin DBs."""
    from click.testing import CliRunner
    import mlcomp_tpu
    import mlcomp_tpu_torch
    from mlcomp_tpu.__main__ import main as jax_main
    from mlcomp_tpu_torch.__main__ import main as port_main
    JaxSession.cleanup('default')
    Session.cleanup('default')
    monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', twin.jax_cs)
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                        twin.port_cs)
    try:
        theirs = CliRunner().invoke(jax_main, [name, *flags])
        capsys.readouterr()
        code = 0
        try:
            port_main([name, *flags])
        except SystemExit as e:
            code = e.code
        out = capsys.readouterr()
    finally:
        JaxSession.cleanup('default')
        Session.cleanup('default')
    return (theirs.exit_code, theirs.output), (code, out.out + out.err)


@pytest.mark.parametrize('name, flags', [
    ('usage', []), ('usage', ['--json']),
    ('usage', ['--group-by', 'project']),
    ('usage', ['--group-by', 'task_class', '--owner', 'alice']),
    ('usage', ['--group-by', 'computer', '--project', 'cv', '--limit', '1']),
    ('quotas', []), ('quotas', ['--json']), ('quotas', ['--limit', '1']),
    ('quotas', ['--set', 'owner:zed:cores=3']),
    ('quotas', ['--set', 'project:nlp:core_seconds=100', '--window', '60']),
    ('quotas', ['--delete', 'owner:alice:cores']),
    ('quotas', ['--delete', 'owner:nobody:cores']),
    ('quotas', ['--delete', 'owner:alice']),
    ('quotas', ['--set', 'owner:alice=x']),
    ('quotas', ['--set', 'team:a:cores=1']),
    ('quotas', ['--set', 'owner:a:cores=1', '--delete', 'owner:a:cores']),
])
def test_the_commands_print_jaxs_text(api_twin, monkeypatch, capsys, name,
                                      flags):
    _tenant_rows(api_twin)
    (their_code, theirs), (code, mine) = _command_outputs(
        api_twin, monkeypatch, capsys, name, flags)
    assert code == their_code
    if '--json' in flags:
        from tests.test_torch_port_api import normalise
        assert normalise(json.loads(mine)) == normalise(json.loads(theirs))
    else:
        assert mine == theirs


def test_an_empty_ledger_and_no_quotas_print_as_jax(api_twin, monkeypatch,
                                                    capsys):
    outs = [_command_outputs(api_twin, monkeypatch, capsys, name, [])
            for name in ('usage', 'quotas')]
    for theirs, mine in outs:
        assert mine == theirs
    assert outs[0][1][1] == 'usage ledger is empty\n'
    assert outs[1][1][1].startswith(
        'no quotas configured (every tenant unlimited)\nclasses:\n')


# ------------------------------------------------------ worker and resume
from tests.test_torch_port_worker import _consume, daemon  # noqa: E402

_ = daemon

#: a victim that runs until it is killed; its exit waits for the file
#: ``release`` (as the trainer's ``finally`` writes its rows and drains
#: its checkpoint writer)
HANG_VICTIM = '''
import os
import time

from mlcomp_tpu_torch.worker.executors import Executor


@Executor.register
class PreemptHang(Executor):
    def __init__(self, release=None, **kwargs):
        self.release = release

    def work(self):
        try:
            time.sleep(120)
        finally:
            deadline = time.monotonic() + 60
            while not os.path.exists(self.release) and \\
                    time.monotonic() < deadline:
                time.sleep(0.05)
        return {}
'''

#: the retry pass's backoff in the worker cases: ~0.1 s
FAST_RETRY = {'lease_seconds': 60, 'backoff_base_s': 0.1, 'max_retries': 3}


def _submit_code(session, tmp_path, name, config, code=None):
    from mlcomp_tpu_torch.server.create_dags import dag_standard
    from mlcomp_tpu_torch.utils.io import yaml_dump
    folder = tmp_path / name
    folder.mkdir()
    if code is not None:
        (folder / 'executors.py').write_text(code)
    (folder / 'config.yml').write_text(yaml_dump(config))
    _, tasks = dag_standard(session, config, upload_folder=str(folder))
    return tasks


def _wait(what, probe, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        got = probe()
        if got:
            return got
        assert time.monotonic() < deadline, f'no {what}'
        time.sleep(0.05)


def _ticker(session):
    """A tick after a fresh heartbeat of host1's queue (a ``run-task``
    start can outlast the 15 s liveness window under load)."""
    from mlcomp_tpu_torch.db.providers import DockerProvider
    sup = SupervisorBuilder(session=session,
                            recovery_config=RecoveryConfig(**FAST_RETRY))

    def tick():
        DockerProvider(session).heartbeat('host1', 'default')
        sup.build()
    return tick


def _high_task(session, name='boss'):
    boss = Task(name=name, executor='noop', cores=1, cores_max=1,
                status=int(TaskStatus.NotRan), priority='high',
                owner='bob', last_activity=now())
    TaskProvider(session).add(boss)
    return boss.id


@pytest.mark.parametrize('exits', ['before_requeue', 'after_requeue'])
def test_a_preempted_process_never_touches_the_next_attempt(
        daemon, tmp_path, exits):
    """The eviction SIGTERMs the victim's ``run-task`` process, which
    exits 143: the row stays ``Failed``/``preempted`` until the retry
    pass, and the worker's post-exit verdict never touches attempt 1,
    whether the process exits before the requeue or after attempt 1 has
    been dispatched again."""
    session, provider = daemon, TaskProvider(daemon)
    release = tmp_path / 'release'
    tasks = _submit_code(session, tmp_path, 'victim', {
        'info': {'name': 'victim', 'project': 'p_victim'},
        'executors': {'victim': {'type': 'preempt_hang', 'cores': 1,
                                 'release': str(release)}}}, HANG_VICTIM)
    (victim,) = tasks['victim']
    session.execute("UPDATE task SET priority='preemptible' WHERE id=?",
                    (victim,))
    tick = _ticker(session)
    tick()
    first_msg = provider.by_id(victim).queue_id
    consumer = threading.Thread(target=_consume, args=(session, False))
    consumer.start()
    try:
        _wait('victim process', lambda: provider.by_id(victim).status ==
              int(TaskStatus.InProgress) and provider.by_id(victim).pid)
        boss = _high_task(session)
        tick()                          # the eviction
        row = provider.by_id(victim)
        assert (row.status, row.failure_reason, row.attempt or 0) == (
            int(TaskStatus.Failed), 'preempted', 0)
        assert [(p.task, p.initiator, p.applied) for p in
                PreemptionProvider(session).recent()] == [
            (victim, boss, True)]
        if exits == 'before_requeue':
            release.touch()
            consumer.join(timeout=60)
            row = provider.by_id(victim)
            assert (row.status, row.failure_reason, row.attempt or 0) == (
                int(TaskStatus.Failed), 'preempted', 0)
        tick()                          # the initiator placed
        assert provider.by_id(boss).status == int(TaskStatus.Queued)
        time.sleep(0.3)                      # the backoff
        tick()                          # the retry: attempt 1 waits
        session.execute('UPDATE task SET status=? WHERE id=?',
                        (int(TaskStatus.Success), boss))
        tick()                          # attempt 1 dispatched
        row = provider.by_id(victim)
        assert (row.status, row.attempt) == (int(TaskStatus.Queued), 1)
        assert row.queue_id != first_msg
        if exits == 'after_requeue':
            release.touch()
            consumer.join(timeout=60)
    finally:
        release.touch()
        consumer.join(timeout=60)
    assert not consumer.is_alive()
    msg = session.query_one('SELECT status, result FROM queue_message '
                            'WHERE id=?', (first_msg,))
    assert tuple(msg) == ('failed', 'subprocess failed (rc=143)')
    row = provider.by_id(victim)
    assert (row.status, row.attempt, row.failure_reason) == (
        int(TaskStatus.Queued), 1, 'preempted')
    assert [(u.task, u.attempt, u.status) for u in
            UsageProvider(session).recent()] == [
        (boss, 0, int(TaskStatus.Success)),
        (victim, 0, int(TaskStatus.Failed))]


MOVED_ON = '''
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.providers import TaskProvider
from mlcomp_tpu_torch.worker.executors import Executor


@Executor.register
class MovedOn(Executor):
    def work(self):
        provider = TaskProvider(self.session)
        row = provider.by_id(self.task.id)
        row.attempt = (row.attempt or 0) + 1
        provider.update(row, ['attempt'])
        provider.change_status(row, TaskStatus.Queued)
        return {}
'''


def test_an_in_process_run_writes_nothing_over_a_newer_attempt(daemon,
                                                               tmp_path):
    """The task pipeline's last write is this run's only while the row
    is its attempt: a run whose row the retry pass moved on (here, the
    executor moves it itself) leaves the newer attempt as it is."""
    session, provider = daemon, TaskProvider(daemon)
    tasks = _submit_code(session, tmp_path, 'moved', {
        'info': {'name': 'moved', 'project': 'p_moved'},
        'executors': {'run': {'type': 'moved_on'}}}, MOVED_ON)
    SupervisorBuilder(session=session).build()
    assert _consume(session, in_process=True)
    row = provider.by_id(tasks['run'][0])
    assert (row.status, row.attempt) == (int(TaskStatus.Queued), 1)


def test_the_stop_rule_reads_terminal_rows_and_newer_attempts(daemon):
    from mlcomp_tpu_torch.contrib.search.asha import cell_is_terminal
    provider = TaskProvider(daemon)
    task = Task(name='t', executor='noop', status=int(TaskStatus.InProgress),
                last_activity=now())
    provider.add(task)
    assert not cell_is_terminal(daemon, task.id)
    assert not cell_is_terminal(daemon, task.id, attempt=0)
    assert cell_is_terminal(daemon, task.id, attempt=1)
    provider.fail_with_reason(task, 'preempted')
    assert cell_is_terminal(daemon, task.id)
    assert not cell_is_terminal(daemon, task.id + 1, attempt=0)


def _mlp_train(epochs, n_train=128):
    return {'type': 'train', 'device': 'cpu', 'cores': 1,
            'model': {'name': 'mlp', 'num_classes': 4, 'hidden': [16],
                      'dtype': 'float32'},
            'dataset': {'name': 'synthetic_images', 'n_train': n_train,
                        'n_valid': 32, 'image_size': 8, 'channels': 1,
                        'num_classes': 4},
            'batch_size': 32, 'checkpoint_every': 1,
            'async_checkpoint': False, 'telemetry': False,
            'stages': [{'name': 's1', 'epochs': epochs,
                        'optimizer': {'name': 'adamw', 'lr': 1e-3}}]}


def test_an_in_process_victim_stops_and_resumes_after_its_checkpoint(
        daemon, tmp_path, monkeypatch):
    """End to end on the CPU: one card slot, an in-process worker thread
    and the tick. A ``preemptible`` MLP run (6 epochs, a checkpoint an
    epoch) is evicted for a ``high`` one once it saved epoch 1; no
    signal reaches it, so it stops at its next epoch boundary. The
    initiator trains, the retry pass requeues the victim, which resumes
    at the epoch after its last checkpoint and ends ``Success`` with
    every epoch trained once. The ledger holds exactly the victim's two
    attempts and the initiator's row.

    The victim's first attempt waits at its ``train.epoch`` seam after
    epoch 1 until its row went terminal or moved on, so the eviction
    lands mid-run however long the submit and the tick take."""
    import mlcomp_tpu_torch
    from mlcomp_tpu_torch.testing import faults
    from mlcomp_tpu_torch.train import executor as train_executor
    from mlcomp_tpu_torch.train.checkpoint import load_meta
    session, provider = daemon, TaskProvider(daemon)
    victim = _submit_code(session, tmp_path, 'v', {
        'info': {'name': 'v', 'project': 'p_v'},
        'executors': {'train': _mlp_train(6)}})['train'][0]
    session.execute("UPDATE task SET priority='preemptible', "
                    "owner='alice' WHERE id=?", (victim,))
    stop = threading.Event()
    pool = Session.create_session(key=f'pool-{tmp_path}',
                                  connection_string=session.connection_string)

    def slot():
        while not stop.is_set():
            if not _consume(pool, in_process=True):
                time.sleep(0.05)

    gate = TaskProvider(Session.create_session(
        key=f'gate-{tmp_path}', connection_string=session.connection_string))
    finished = {int(s) for s in TaskStatus.finished()}
    seam = train_executor.fault_point

    def evicted():
        row = gate.by_id(victim)
        return row.status in finished or row.attempt > 0

    def held(name, **ctx):
        seam(name, **ctx)
        if name == 'train.epoch' and ctx.get('task') == victim and \
                ctx.get('epoch') == 2:
            _wait('the eviction', evicted, timeout=120)

    monkeypatch.setattr(train_executor, 'fault_point', held)
    tick = _ticker(session)
    worker = threading.Thread(target=slot)
    # an epoch of ~0.3 s after each boundary
    faults.configure_faults({'train.epoch': {'action': 'sleep', 'ms': 300,
                                             'times': None}})
    ck_dir = f'{mlcomp_tpu_torch.TASK_FOLDER}/{victim}/checkpoints'
    try:
        worker.start()
        tick()
        _wait('checkpoint of epoch 1', lambda: (load_meta(ck_dir) or {}).get(
            'epoch', -1) >= 1)
        boss = _submit_code(session, tmp_path, 'h', {
            'info': {'name': 'h', 'project': 'p_h'},
            'executors': {'train': _mlp_train(2)}})['train'][0]
        session.execute("UPDATE task SET priority='high', owner='bob' "
                        "WHERE id=?", (boss,))
        deadline = time.monotonic() + 120
        while not (provider.by_id(victim).status == int(TaskStatus.Success)
                   and provider.by_id(boss).status in finished):
            assert time.monotonic() < deadline, 'the runs did not finish'
            tick()
            time.sleep(0.1)
        tick()
    finally:
        faults.clear_faults()
        stop.set()
        worker.join(timeout=60)
        Session.cleanup(pool.key)
        Session.cleanup(gate.session.key)
    assert provider.by_id(boss).status == int(TaskStatus.Success)
    (dec,) = PreemptionProvider(session).recent()
    assert (dec.task, dec.attempt, dec.initiator, dec.victim_class,
            dec.initiator_class, dec.reason, dec.applied) == (
        victim, 0, boss, 'preemptible', 'high', 'capacity', True)
    logs = [r['message'] for r in session.query(
        'SELECT message FROM log WHERE task=? ORDER BY id', (victim,))]
    stopped = [m for m in logs if m.startswith('stopped after epoch ')]
    resumed = [m for m in logs if m.startswith('resumed from checkpoint')]
    assert len(stopped) == 1 and len(resumed) == 1, logs
    last = int(stopped[0].split()[3].rstrip(':'))
    assert f'epoch={last} ' in resumed[0]
    epochs = [r['epoch'] for r in session.query(
        "SELECT epoch FROM report_series WHERE task=? AND part='train' "
        "AND name='loss' ORDER BY id", (victim,))]
    assert epochs == list(range(6)) and 1 <= last < 5
    assert provider.by_id(victim).attempt == 1
    assert [(u.task, u.attempt, u.status, u.owner) for u in reversed(
        UsageProvider(session).recent())] == [
        (victim, 0, int(TaskStatus.Failed), 'alice'),
        (boss, 0, int(TaskStatus.Success), 'bob'),
        (victim, 1, int(TaskStatus.Success), 'alice')]

"""The port's supervisor tick against the JAX package's, on twin sqlite
DBs: the rows of a scenario are written through the JAX package's
providers, the file is copied, and ``SupervisorBuilder.build()`` of each
package ticks its own copy. After every tick both DBs hold the same task
rows (status, assignment, cores, queue id, failure reason, attempt), the
same queue messages (payload without its trace id) and alerts, and the
same decision trace (dispatched, not placed, tasks to process, parent
aggregation, preflight blocks, retries, lease reclaims and strands,
preemptions, usage folds) and the same ``preemption`` and ``usage``
rows.
Times are set far from every boundary (aging, backoff, lease, liveness),
so the two ticks' clocks, a few milliseconds apart, decide alike.

Also here: the queue provider on both claim paths against JAX's (and
at-most-once claims under threads), the event bus, the scheduling
policy's pure functions, and the refusals of what is not ported.
Quotas, preemption and the usage ledger have their own scenarios in
``tests/test_torch_port_quota.py``."""

import datetime
import json
import shutil
import threading
import time

import pytest

from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.enums import TaskStatus as JaxStatus, TaskType as JaxType
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.db.models import Computer as JaxComputer
from mlcomp_tpu.db.models import Dag as JaxDag
from mlcomp_tpu.db.models import Task as JaxTask
from mlcomp_tpu.db.providers import (
    DockerProvider as JaxDocker, QueueProvider as JaxQueue,
    TaskProvider as JaxTasks,
)
from mlcomp_tpu.recovery import RecoveryConfig as JaxRecovery
from mlcomp_tpu.server.create_dags.standard import (
    dag_standard as jax_dag_standard,
)
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu.utils.io import yaml_dump as jax_yaml_dump
from mlcomp_tpu.utils.misc import now
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.providers import QueueProvider
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server.supervisor import (
    SupervisorBuilder, register_supervisor,
)

#: the decision trace's keys compared between the packages
AUX_KEYS = ('dispatched', 'not_placed', 'tasks_to_process',
            'parent_tasks', 'preflight_blocked', 'retried',
            'retry_exhausted', 'lease_reclaimed', 'lease_stranded',
            'gang_aborted', 'queues', 'preempted', 'usage_folded')

#: recovery knobs of every scenario: a 60 s lease, a 60 s backoff
RECOVERY = {'lease_seconds': 60, 'backoff_base_s': 60, 'max_retries': 3}


def _ago(seconds: float):
    return now() - datetime.timedelta(seconds=seconds)


class Twin:
    """One scenario's two DBs and the two packages' builders."""

    #: what a routed kill's payload carries besides action and task: an
    #: HA builder stamps its fencing epoch (tests/test_torch_port_ha.py)
    kill_stamp = {}

    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self.key = f'twin-{tmp_path}'
        self.jax = JaxSession.create_session(
            key=self.key, connection_string=f'sqlite:///{tmp_path}/jax.db')
        jax_migrate(self.jax)
        dag, _ = jax_dag_standard(self.jax, {
            'info': {'name': 'twin', 'project': 'p_twin'},
            'executors': {'noop': {'type': 'valid_classify', 'y': '1'}}})
        self.dag = dag.id
        self.jax.execute('DELETE FROM task')    # rows come per scenario
        self.port = None

    # ----------------------------------------------------- JAX-side rows
    def computer(self, name, cores=8, cpu=16, memory=64.0, alive=True):
        self.jax.add(JaxComputer(name=name, cores=cores, cpu=cpu,
                                 memory=memory, ip='127.0.0.1',
                                 can_process_tasks=True))
        if alive:
            JaxDocker(self.jax).heartbeat(name, 'default')

    def task(self, name, status=JaxStatus.NotRan, cores=1, cores_max=None,
             cpu=1, memory=0.5, waited=120.0, **fields):
        task = JaxTask(
            name=name, executor='noop', dag=fields.pop('dag', self.dag),
            status=int(status), cores=cores,
            cores_max=cores if cores_max is None else cores_max,
            cpu=cpu, memory=memory,
            single_node=fields.pop('single_node', True),
            last_activity=_ago(waited), **fields)
        JaxTasks(self.jax).add(task)
        return task.id

    def depend(self, task_id, on_id):
        JaxTasks(self.jax).add_dependency(task_id, on_id)

    def message(self, task_id, queue, **fields):
        msg_id = JaxQueue(self.jax).enqueue(
            queue, {'action': 'execute', 'task_id': task_id})
        sets = ', '.join(f'{k}=?' for k in fields)
        if sets:
            self.jax.execute(f'UPDATE queue_message SET {sets} WHERE id=?',
                             (*fields.values(), msg_id))
        self.jax.execute('UPDATE task SET queue_id=? WHERE id=?',
                         (msg_id, task_id))
        return msg_id

    # ------------------------------------------------------------ ticks
    def start(self):
        """Copy the JAX DB for the port, then build both supervisors."""
        JaxSession.cleanup(self.key)           # checkpoints the WAL
        shutil.copy(self.tmp_path / 'jax.db', self.tmp_path / 'port.db')
        self.jax = JaxSession.create_session(
            key=self.key,
            connection_string=f'sqlite:///{self.tmp_path}/jax.db')
        self.port = Session.create_session(
            key=self.key,
            connection_string=f'sqlite:///{self.tmp_path}/port.db')
        self.jax_sup = JaxSupervisor(session=self.jax,
                                     recovery_config=JaxRecovery(**RECOVERY))
        self.port_sup = SupervisorBuilder(
            session=self.port, recovery_config=RecoveryConfig(**RECOVERY))

    def both(self, sql, params=()):
        """The same statement on both DBs (a clock moving on)."""
        self.jax.execute(sql, params)
        self.port.execute(sql, params)

    def tick(self):
        self.jax_sup.build()
        self.port_sup.build()
        theirs, mine = state(self.jax), state(self.port)
        assert mine == theirs
        return mine

    def close(self):
        JaxSession.cleanup(self.key)
        Session.cleanup(self.key)


class TickSeconds(float):
    """A duration that a tick's clock stamped: equal to another within
    0.5 s (the two packages' ticks run milliseconds apart)."""

    def __eq__(self, other):
        return other is not None and abs(float(self) - float(other)) <= 0.5

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = float.__hash__


def state(session) -> dict:
    tasks = [(r['id'], r['name'], r['status'], r['computer_assigned'],
              r['cores_assigned'], r['queue_id'], r['failure_reason'],
              r['attempt'])
             for r in session.query('SELECT * FROM task ORDER BY id')]
    messages = []
    for r in session.query('SELECT * FROM queue_message ORDER BY id'):
        payload = json.loads(r['payload'])
        payload.pop('trace_id', None)
        messages.append((r['id'], r['queue'], r['status'], payload,
                         r['claimed_by'], r['redelivered']))
    alerts = [(r['rule'], r['task'], r['severity'], r['status'])
              for r in session.query('SELECT * FROM alert ORDER BY id')]
    # the ledger and the audit trail, their write times aside; a task
    # that a tick starts or finishes, or a message a scenario's worker
    # claims, carries that package's clock, so the seconds derived from
    # them are held to 0.5 s
    usage = [tuple(TickSeconds(v) if k in ('core_seconds', 'queue_wait_s')
                   and v is not None else v for k, v in dict(r).items()
                   if k not in ('created', 'started', 'finished'))
             for r in session.query('SELECT * FROM usage ORDER BY id')]
    preemptions = [tuple(v for k, v in dict(r).items() if k != 'time')
                   for r in session.query(
                       'SELECT * FROM preemption ORDER BY id')]
    row = session.query_one(
        "SELECT data FROM auxiliary WHERE name='supervisor'")
    aux = json.loads(row['data']) if row else {}
    assert aux.get('duration') is not None, 'the tick failed and healed'
    return {'tasks': tasks, 'messages': messages, 'alerts': alerts,
            'usage': usage, 'preemptions': preemptions,
            'aux': {k: aux.get(k) for k in AUX_KEYS}}


@pytest.fixture()
def twin(tmp_path):
    t = Twin(tmp_path)
    yield t
    t.close()


def _dispatched(st):
    return {d['task']: d['cores'] for d in st['aux']['dispatched'] or []}


# --------------------------------------------------------------- scenarios
def test_placement_and_no_live_queue(twin):
    twin.computer('host1', cores=8)
    twin.computer('dead', cores=8, alive=False)
    placed = twin.task('placed', cores=2)
    pinned = twin.task('pinned_to_dead', computer='dead')
    twin.start()
    st = twin.tick()
    assert _dispatched(st) == {placed: [0, 1]}
    assert 'not alive' in str(st['aux']['not_placed'][str(pinned)])
    assert [m[1:4] for m in st['messages']] == [
        ('host1_default', 'pending',
         {'action': 'execute', 'task_id': placed})]
    twin.tick()                     # nothing new: no second message


def test_cpu_memory_gate_pin_and_packing_order(twin):
    twin.computer('small', cores=2, cpu=2, memory=4)
    twin.computer('big', cores=8, cpu=16, memory=64)
    twin.computer('mid', cores=4, cpu=16, memory=64)
    twin.task('busy', status=JaxStatus.InProgress, cores=3,
              computer_assigned='big', cores_assigned='[0, 1, 2]')
    cpu_heavy = twin.task('cpu_heavy', cpu=8)
    mem_heavy = twin.task('mem_heavy', memory=32)
    too_much = twin.task('too_much', cpu=64)
    pinned = twin.task('pinned', computer='small')
    wide = twin.task('wide', cores=4)
    twin.start()
    st = twin.tick()
    assert set(_dispatched(st)) == {cpu_heavy, mem_heavy, pinned, wide}
    assert 'cpu' in str(st['aux']['not_placed'][str(too_much)])


def test_waiting_and_failed_dependencies(twin):
    twin.computer('host1')
    running = twin.task('running', status=JaxStatus.InProgress,
                        computer_assigned='host1', cores_assigned='[0]')
    failed = twin.task('failed', status=JaxStatus.Failed,
                       failure_reason='executor-error')
    waits = twin.task('waits')
    skipped = twin.task('skipped')
    twin.depend(waits, running)
    twin.depend(skipped, failed)
    twin.start()
    st = twin.tick()
    statuses = {t[0]: t[2] for t in st['tasks']}
    assert statuses[waits] == int(TaskStatus.NotRan)
    assert statuses[skipped] == int(TaskStatus.Skipped)


def test_parent_aggregation_with_a_failed_child(twin):
    twin.computer('host1')
    service = {'type': int(JaxType.Service)}
    done = twin.task('parent_done', status=JaxStatus.InProgress)
    for i in range(2):
        twin.task(f'done_{i}', status=JaxStatus.Success, parent=done,
                  **service)
    running = twin.task('parent_running', status=JaxStatus.Queued)
    twin.task('child_running', status=JaxStatus.InProgress,
              parent=running, computer_assigned='host1',
              cores_assigned='[0]', **service)
    gang = twin.task('parent_gang', status=JaxStatus.InProgress,
                     gang_id='g1', gang_generation=1)
    twin.task('rank_failed', status=JaxStatus.Failed, parent=gang,
              failure_reason='preempted', computer_assigned='host2',
              **service)
    survivor = twin.task(
        'rank_alive', status=JaxStatus.InProgress, parent=gang,
        computer_assigned='host2', cores_assigned='[1]', pid=2 ** 22,
        additional_info=jax_yaml_dump({'distr_info': {
            'process_index': 1, 'process_count': 2}}), **service)
    twin.start()
    st = twin.tick()
    statuses = {t[0]: (t[2], t[6]) for t in st['tasks']}
    assert statuses[done][0] == int(TaskStatus.Success)
    assert statuses[running][0] == int(TaskStatus.InProgress)
    assert statuses[gang] == (int(TaskStatus.Failed), 'preempted')
    assert statuses[survivor] == (int(TaskStatus.Failed), 'gang-aborted')
    # the survivor's kill is routed to its host's control queue
    assert ('host2_default_supervisor', 'pending',
            {'action': 'kill', 'task_id': survivor, **twin.kill_stamp}) in \
        [m[1:4] for m in st['messages']]
    twin.tick()


def test_priority_and_aging_order(twin):
    twin.computer('host1', cores=5)
    aged = twin.task('aged_preemptible', priority='preemptible',
                     waited=11 * 60)
    fresh = twin.task('fresh_preemptible', priority='preemptible')
    normal = twin.task('normal')
    high = twin.task('high', priority='high')
    critical = twin.task('critical', priority='critical')
    twin.start()
    st = twin.tick()
    # eleven minutes of aging lift a preemptible task two classes, to
    # high's rank, and the older row goes first among equals
    assert st['aux']['tasks_to_process'] == [critical, aged, high, normal,
                                             fresh]
    assert _dispatched(st) == {critical: [0], aged: [1], high: [2],
                               normal: [3], fresh: [4]}


def test_transient_failure_retried_after_backoff_elsewhere(twin):
    twin.computer('host1')
    twin.computer('host2')
    due = twin.task('due', status=JaxStatus.Failed,
                    failure_reason='worker-lost', computer_assigned='host1',
                    next_retry_at=_ago(600))
    scheduled = twin.task('scheduled', status=JaxStatus.Failed,
                          failure_reason='preempted',
                          computer_assigned='host2')
    permanent = twin.task('permanent', status=JaxStatus.Failed,
                          failure_reason='executor-error')
    twin.start()
    st = twin.tick()
    rows = {t[0]: t for t in st['tasks']}
    assert rows[due][2:5] == (int(TaskStatus.Queued), 'host2', '[0]')
    assert rows[due][7] == 1
    assert rows[scheduled][2] == int(TaskStatus.Failed)
    assert rows[permanent][2] == int(TaskStatus.Failed)
    assert [r['task'] for r in st['aux']['retried']] == [due]
    # the backoff of the other one passes
    twin.both('UPDATE task SET next_retry_at=? WHERE id=?',
              (_ago(600), scheduled))
    st = twin.tick()
    assert {t[0]: t[3] for t in st['tasks']}[scheduled] == 'host1'


def test_retry_exhausted_raises_one_alert(twin):
    twin.computer('host1')
    spent = twin.task('spent', status=JaxStatus.Failed,
                      failure_reason='io-error', attempt=3,
                      finished=_ago(600))
    twin.start()
    st = twin.tick()
    assert st['alerts'] == [('retry-exhausted', spent, 'critical', 'open')]
    st = twin.tick()
    assert len(st['alerts']) == 1 and st['aux']['retry_exhausted'] is None


def test_lease_reclaim_once_then_strand_sweep(twin):
    twin.computer('host1')
    twin.computer('dead', alive=False)
    queued = twin.task('claimed_on_dead', status=JaxStatus.Queued,
                       computer_assigned='dead', cores_assigned='[0]')
    msg = twin.message(queued, 'dead_default', status='claimed',
                       claimed_by='dead:0', claimed_at=_ago(600))
    second = twin.task('second_death', status=JaxStatus.Queued,
                       computer_assigned='dead', cores_assigned='[1]')
    twin.message(second, 'dead_default', status='claimed',
                 claimed_by='dead:1', claimed_at=_ago(600), redelivered=1)
    alive = twin.task('claimed_on_live', status=JaxStatus.Queued,
                      computer_assigned='host1', cores_assigned='[0]')
    twin.message(alive, 'host1_default', status='claimed',
                 claimed_by='host1:0', claimed_at=_ago(600))
    twin.start()
    st = twin.tick()
    assert [r['msg'] for r in st['aux']['lease_reclaimed']] == [msg]
    assert {t[0]: t[6] for t in st['tasks']}[second] == 'lease-expired'
    st = twin.tick()                # exactly once: nothing to reclaim
    assert st['aux']['lease_reclaimed'] is None
    # nobody claimed the re-delivery for a lease window: stranded
    twin.both('UPDATE queue_message SET claimed_at=? WHERE id=?',
              (_ago(600), msg))
    st = twin.tick()
    assert st['aux']['lease_stranded'] == [{'msg': msg,
                                            'queue': 'dead_default'}]
    assert {t[0]: t[6] for t in st['tasks']}[queued] == 'lease-expired'


def test_preflight_blocks_a_dag_that_skipped_the_gate(twin):
    from mlcomp_tpu.db.providers import DagProvider as JaxDags
    twin.computer('host1')
    config = {'info': {'name': 'cycle', 'project': 'p_twin'},
              'executors': {
                  'a': {'type': 'valid_classify', 'y': '1', 'depends': 'b'},
                  'b': {'type': 'valid_classify', 'y': '1',
                        'depends': 'a'}}}
    dag = JaxDag(name='cycle', config=jax_yaml_dump(config),
                 project=twin.jax.query_one('SELECT project FROM dag')[0],
                 created=now())
    JaxDags(twin.jax).add(dag)
    blocked = twin.task('a', dag=dag.id)
    twin.start()
    st = twin.tick()
    assert list(st['aux']['preflight_blocked']) == [str(blocked)]
    assert {t[0]: t[2] for t in st['tasks']}[blocked] == \
        int(TaskStatus.Skipped)


# ----------------------------------------------------------------- refusals
def test_multi_host_fan_out_raises_naming_a4_and_the_task_waits(twin):
    twin.computer('host1')
    gang = twin.task('gang', cores=2, cores_max=2, single_node=False)
    twin.start()
    twin.port_sup.build()
    row = twin.port.query_one('SELECT status FROM task WHERE id=?', (gang,))
    assert row['status'] == int(TaskStatus.NotRan)
    task = twin.port_sup.provider.by_id(gang)
    with pytest.raises(NotImplementedError, match=r'A4'):
        twin.port_sup.process_task(task)


def test_ha_raises_naming_supervisor_ha(tmp_path):
    """Supervisor HA is ported: ``register_supervisor()`` (``ha=True``,
    the JAX default) no longer raises; its loop holds the lease, ticks
    on the fenced session, and releases the lease when it stops."""
    from mlcomp_tpu_torch.db.fencing import FencedSession
    from mlcomp_tpu_torch.db.migration import migrate
    s = Session.create_session(key=f'ha-{tmp_path}',
                               connection_string=f'sqlite:///{tmp_path}/h.db')
    try:
        migrate(s)
        builder, (loop,) = register_supervisor(session=s)
        deadline = time.monotonic() + 10
        while loop.promotions == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        lease = s.query_one('SELECT * FROM supervisor_lease WHERE id=1')
        assert isinstance(builder.session, FencedSession)
        assert lease['holder'] == builder.lease.holder and \
            lease['epoch'] == builder.lease.epoch == 1
        loop.stop()
        loop.join(timeout=10)
        lease = s.query_one('SELECT * FROM supervisor_lease WHERE id=1')
        assert lease['holder'] is None and lease['epoch'] == 1
    finally:
        Session.cleanup(s.key)


@pytest.mark.parametrize('table, row, item', [
    ('sweep', "(dag, executor, name, metric) VALUES (1, 'e', 's', 'm')",
     'ASHA sweeps'),
    ('quota', "(scope, tenant, resource, limit_value) "
              "VALUES ('owner', 'a', 'cores', 4)",
     'quotas and preemption'),
])
def test_fleet_sweep_and_quota_rows_raise(twin, table, row, item):
    """Neither a sweep row nor a quota row raises any more (ASHA sweeps
    and quotas are ported, the ROADMAP.md items named here): both ticks
    serve the row alike. A sweep whose dag has no cells stays active; a
    quota on another tenant leaves this one's task unlimited."""
    twin.computer('host1')
    waits = twin.task('waits')
    twin.jax.execute(f'INSERT INTO {table} {row}')
    twin.start()
    st = twin.tick()
    assert _dispatched(st) == {waits: [0]}
    rows = [tuple(session.query_one(f'SELECT * FROM {table}'))
            for session in (twin.jax, twin.port)]
    assert rows[0] == rows[1] and 'done' not in rows[1]


def test_preemption_raises_where_jax_evicts(twin):
    """Where the JAX tick evicts, the port's evicts the same victim
    (``preempted``, one applied ``preemption`` row), bills its attempt
    in the same tick and places the initiator on the next."""
    twin.computer('host1', cores=1)
    victim = twin.task('victim', status=JaxStatus.InProgress,
                       priority='preemptible', computer_assigned='host1',
                       cores_assigned='[0]', started=_ago(30))
    blocked = twin.task('blocked', priority='high')
    twin.start()
    st = twin.tick()
    assert st['tasks'][0][0] == victim
    assert st['tasks'][0][2:7:4] == (int(TaskStatus.Failed), 'preempted')
    assert st['aux']['preempted'] == [
        {'task': victim, 'attempt': 0, 'class': 'preemptible',
         'reason': 'capacity', 'repair': False}]
    assert len(st['preemptions']) == 1 and len(st['usage']) == 1
    st = twin.tick()
    assert _dispatched(st) == {blocked: [0]}


# --------------------------------------------------------------- the queue
QUEUE_SCRIPT = [
    ('enqueue', ('q1', {'task_id': 1})), ('enqueue', ('q1', {'task_id': 2})),
    ('enqueue', ('q2', {'task_id': 3})),
    ('enqueue_many', ([('q2', {'task_id': 4}), ('q1', {'task_id': 5})],)),
    ('find_active', ('q1', {'task_id': 2})),
    ('find_active', ('q1', {'task_id': 9})),
    ('claim', (['q1', 'q2'], 'w:0')), ('claim_many', (['q2'], 'w:1', 5)),
    ('complete', (1, 'ok', 'w:1')), ('complete', (1, 'ok', 'w:0')),
    ('fail', (3, 'boom', 'w:1')), ('revoke', (2,)), ('revoke', (4,)),
    ('status', (2,)), ('claim_many', (['q1'], 'w:2', 2)),
    ('reclaim', (5,)), ('reclaim', (5,)), ('claim', (['q1'], 'w:3')),
    ('expire_claim', (5,)), ('enqueue', ('q3', {'task_id': 6})),
    ('claim', (['q3'], 'w:4')), ('reclaim', (6,)), ('fail_stranded', (6,)),
    ('status', (6,)), ('pending', ('q1',)), ('purge', ()),
]


def _run_queue_script(provider):
    out = []
    for name, args in QUEUE_SCRIPT:
        result = getattr(provider, name)(*args)
        if name == 'pending':
            result = [(m.id, m.queue, m.payload) for m in result]
        out.append((name, result))
    out.append(('pending_index', provider.pending_index()))
    rows = [(r['id'], r['queue'], r['payload'], r['status'], r['result'],
             r['claimed_by'], r['redelivered'])
            for r in provider.session.query(
                'SELECT * FROM queue_message ORDER BY id')]
    return out, rows


@pytest.mark.parametrize('returning', [True, False],
                         ids=['returning', 'select_update'])
def test_queue_provider_gives_jax_results(tmp_path, monkeypatch, returning):
    import mlcomp_tpu.db.providers.queue as jax_queue
    import mlcomp_tpu_torch.db.providers.queue as port_queue
    monkeypatch.setattr(jax_queue, '_RETURNING_OK', returning)
    monkeypatch.setattr(port_queue, '_RETURNING_OK', returning)
    jax = JaxSession.create_session(
        key=f'q-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/j.db')
    port = Session.create_session(
        key=f'q-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/p.db')
    try:
        jax_migrate(jax)
        from mlcomp_tpu_torch.db.migration import migrate
        migrate(port)
        assert _run_queue_script(QueueProvider(port)) == \
            _run_queue_script(JaxQueue(jax))
    finally:
        JaxSession.cleanup(jax.key)
        Session.cleanup(port.key)


@pytest.mark.parametrize('returning', [True, False],
                         ids=['returning', 'select_update'])
def test_claims_are_at_most_once_under_threads(tmp_path, monkeypatch,
                                               returning):
    """Eight claimers, each on a connection of its own, drain 60
    messages: every message is claimed exactly once, by the claimer the
    row names."""
    import sys
    import mlcomp_tpu_torch.db.providers.queue as port_queue
    from mlcomp_tpu_torch.db.migration import migrate
    monkeypatch.setattr(port_queue, '_RETURNING_OK', returning)
    url = f'sqlite:///{tmp_path}/t.db'
    keys = [f'claim-{tmp_path}-{i}' for i in range(9)]
    sessions = [Session.create_session(key=k, connection_string=url)
                for k in keys]
    migrate(sessions[0])
    QueueProvider(sessions[0]).enqueue_many(
        [('q', {'task_id': i}) for i in range(60)])
    claimed = {i: [] for i in range(8)}

    def claimer(i):
        provider = QueueProvider(sessions[i + 1])
        while True:
            got = provider.claim_many(['q'], f'w:{i}', 2)
            if not got:
                return
            claimed[i] += [m for m, _ in got]

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=claimer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        for k in keys:
            Session.cleanup(k)
    every = sorted(m for ids in claimed.values() for m in ids)
    assert every == list(range(1, 61))
    s = Session.create_session(key=keys[0], connection_string=url)
    try:
        for i, ids in claimed.items():
            for m in ids:
                row = s.query_one('SELECT claimed_by, status FROM '
                                  'queue_message WHERE id=?', (m,))
                assert tuple(row) == (f'w:{i}', 'claimed')
    finally:
        Session.cleanup(keys[0])


# ----------------------------------------------------------- the event bus
def test_event_bus_wakes_on_a_publish_after_the_snapshot():
    from mlcomp_tpu_torch.db.events import LocalEventBus
    bus = LocalEventBus()
    snap = bus.snapshot(['tasks'])
    bus.publish('tasks')            # lands before the wait: not lost
    assert bus.wait(['tasks'], 5.0, snapshot=snap)
    assert not bus.wait(['tasks'], 0.01)
    timer = threading.Timer(0.05, bus.publish, args=('queue:done',))
    timer.start()
    assert bus.wait(['tasks', 'queue:done'], 5.0)
    timer.join()
    assert bus.published_count == 2


def test_session_events_stay_in_process(tmp_path):
    s = Session.create_session(key=f'ev-{tmp_path}',
                               connection_string=f'sqlite:///{tmp_path}/e.db')
    try:
        assert s.events_cross_process is False
        snap = s.event_snapshot(['queue:q'])
        s.publish_event('queue:q')
        assert s.wait_event(['queue:q'], 1.0, snapshot=snap)
    finally:
        Session.cleanup(s.key)


# ------------------------------------------------------------- the policy
class _Row:
    def __init__(self, **kw):
        self.__dict__.update({'id': 1, 'priority': None, 'executor': 'x',
                              'type': 0, 'additional_info': None,
                              'last_activity': None, 'owner': None}, **kw)


POLICY_ROWS = [
    {}, {'priority': 'high'}, {'additional_info': 'sweep: {id: 1}'},
    {'executor': 'serve_replica'}, {'type': 1}, {'priority': 'bogus'},
    {'priority': 'preemptible', 'last_activity': 'aged'},
]


@pytest.mark.parametrize('fields', POLICY_ROWS,
                         ids=[str(i) for i in range(len(POLICY_ROWS))])
def test_scheduling_policy_gives_jax_verdicts(fields):
    from mlcomp_tpu.server import scheduler as jax_policy
    from mlcomp_tpu_torch.server import scheduler as policy
    stamp = now()
    if fields.get('last_activity') == 'aged':
        fields = {**fields, 'last_activity': stamp - datetime.timedelta(
            seconds=700)}
    row = _Row(**fields)
    assert policy.task_priority_of(row) == jax_policy.task_priority_of(row)
    assert policy.dispatch_order_key(row, stamp, usage_share=0.25) == \
        jax_policy.dispatch_order_key(row, stamp, usage_share=0.25)
    for wait in (0, 299, 300, 10 ** 4):
        for prio in jax_policy.PRIORITY_CLASSES:
            assert policy.effective_rank(prio, wait) == \
                jax_policy.effective_rank(prio, wait)


def test_quota_share_and_packing_give_jax_verdicts():
    from mlcomp_tpu.server import scheduler as jax_policy
    from mlcomp_tpu_torch.server import scheduler as policy
    limits = {('owner', 'a', 'cores'): (4.0, 86400.0),
              ('owner', 'a', 'core_seconds'): (100.0, 3600.0),
              ('project', 'p', 'cores'): (0.0, 86400.0)}
    live = {('owner', 'a'): 3}
    windowed = {('owner', 'a'): 50.0, ('owner', 'b'): 7.0}
    for args in (('normal', 1, 'a', 'q'), ('normal', 2, 'a', 'q'),
                 ('critical', 9, 'a', 'p'), ('high', 1, 'b', 'p'),
                 ('normal', 1, None, None)):
        assert policy.quota_block(*args, limits, live, windowed) == \
            jax_policy.quota_block(*args, limits, live, windowed)
    for owner in ('a', 'b', None):
        assert policy.tenant_share(owner, limits, windowed) == \
            jax_policy.tenant_share(owner, limits, windowed)
    fits = [('h1', 2), ('h2', 8), ('h3', 4), ('h4', 1)]
    for want in (0, 1, 3, 5, 9):
        for multi, spread in ((False, False), (True, False),
                              (False, True)):
            assert policy.pack_candidates(fits, want, multi, spread) == \
                jax_policy.pack_candidates(fits, want, multi, spread)

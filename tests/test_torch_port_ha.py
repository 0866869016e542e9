"""Supervisor HA on the port (its counterpart of ``tests/test_ha.py``):
the lease protocol, promotion latency, epoch fencing and crash-consistent
dispatch, on the port's own sqlite sessions. JAX's listener-health and
remote-session classes wait with PostgreSQL and the server-proxied DB.

Also here: the cross-package case (both packages share the root and the
schema, so a JAX ``LeaderLease`` holding the lease blocks the port's,
and the port's blocks JAX's), every write the port's tick makes to a
fenced table carrying the fence predicate, and the tick-parity
scenarios of ``tests/test_torch_port_supervisor.py`` once more with a
lease on each side (``ha=True``). Lease windows are rewound in the row
instead of slept out."""

import datetime
import json
import threading
import time

import pytest

from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.providers import (
    SupervisorLeaseProvider as JaxLeaseProvider,
)
from mlcomp_tpu.recovery import RecoveryConfig as JaxRecovery
from mlcomp_tpu.server.ha import LeaderLease as JaxLeaderLease
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.fencing import (
    FENCE_PREDICATE, FENCED_TABLES, FencedSession, FenceLostError,
    fence_rejections, fence_statement,
)
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import Computer, Task
from mlcomp_tpu_torch.db.providers import (
    ComputerProvider, DockerProvider, MetricProvider, QueueProvider,
    SupervisorLeaseProvider, TaskProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server.ha import LeaderLease, StaticLease
from mlcomp_tpu_torch.server.supervisor import (
    SupervisorBuilder, SupervisorLoop,
)
from mlcomp_tpu_torch.utils.misc import now

from tests import test_torch_port_supervisor as tick


@pytest.fixture()
def session(tmp_path):
    s = Session.create_session(key=f'ha-{tmp_path}',
                               connection_string=f'sqlite:///{tmp_path}/h.db')
    migrate(s)
    yield s
    Session.cleanup(s.key)


def _expire_lease(session):
    session.execute(
        'UPDATE supervisor_lease SET expires_at=? WHERE id=1',
        (now() - datetime.timedelta(seconds=1),))


def _add_task(session, name='t', **kw):
    task = Task(name=name, executor='noop', cores=1, cores_max=1,
                status=int(TaskStatus.NotRan), last_activity=now(), **kw)
    TaskProvider(session).add(task)
    return task


def _add_computer(session, name='h1'):
    ComputerProvider(session).create_or_update(
        Computer(name=name, cores=8, cpu=16, memory=64, ip='127.0.0.1',
                 can_process_tasks=True), 'name')
    DockerProvider(session).heartbeat(name, 'default')


class TestLeaseProtocol:
    def test_migration_seeds_singleton(self, session):
        row = SupervisorLeaseProvider(session).current()
        assert row is not None
        assert row.holder is None and (row.epoch or 0) == 0

    def test_acquire_bumps_epoch_renew_keeps_it(self, session):
        p = SupervisorLeaseProvider(session)
        assert p.try_acquire('a:1:x', 30.0) == 1
        assert p.renew('a:1:x', 1, 30.0) is True
        row = p.current()
        assert row.epoch == 1 and row.holder == 'a:1:x'

    def test_live_lease_blocks_rival(self, session):
        p = SupervisorLeaseProvider(session)
        assert p.try_acquire('a:1:x', 30.0) == 1
        assert p.try_acquire('b:2:y', 30.0) is None

    def test_expired_lease_is_taken_with_new_epoch(self, session):
        p = SupervisorLeaseProvider(session)
        assert p.try_acquire('a:1:x', 30.0) == 1
        _expire_lease(session)
        assert p.try_acquire('b:2:y', 30.0) == 2
        assert p.renew('a:1:x', 1, 30.0) is False     # the demotion

    def test_release_is_conditional_on_holder_and_epoch(self, session):
        p = SupervisorLeaseProvider(session)
        assert p.try_acquire('a:1:x', 30.0) == 1
        _expire_lease(session)
        assert p.try_acquire('b:2:y', 30.0) == 2
        assert p.release('a:1:x', 1) is False
        assert p.current().holder == 'b:2:y'
        assert p.release('b:2:y', 2) is True
        row = p.current()
        assert row.holder is None and row.epoch == 2

    def test_racing_acquire_exactly_one_winner(self, session):
        p = SupervisorLeaseProvider(session)
        results = {}
        barrier = threading.Barrier(2)

        def contend(who):
            barrier.wait()
            results[who] = p.try_acquire(who, 30.0)

        threads = [threading.Thread(target=contend, args=(w,))
                   for w in ('racer:1:a', 'racer:2:b')]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        wins = [w for w, epoch in results.items() if epoch is not None]
        assert len(wins) == 1, results
        row = p.current()
        assert row.holder == wins[0] and row.epoch == 1

    def test_roster_heartbeat(self, session):
        lease = LeaderLease(session, holder='h1:42:abc', lease_seconds=30)
        assert lease.ensure() is True
        (row,) = SupervisorLeaseProvider(session).instances()
        assert (row.holder, row.computer, row.pid, row.role, row.epoch) == \
            ('h1:42:abc', 'h1', 42, 'leader', 1)


class TestCrossPackage:
    """Both packages open the same DB file under one root: a leader of
    either package blocks the other's supervisor."""

    @pytest.fixture()
    def shared(self, tmp_path):
        cs = f'sqlite:///{tmp_path}/shared.db'
        port = Session.create_session(key=f'x-{tmp_path}',
                                      connection_string=cs)
        migrate(port)
        jax = JaxSession.create_session(key=f'x-{tmp_path}',
                                        connection_string=cs)
        yield jax, port
        JaxSession.cleanup(f'x-{tmp_path}')
        Session.cleanup(f'x-{tmp_path}')

    def test_jax_leader_blocks_the_port(self, shared):
        jax, port = shared
        theirs = JaxLeaderLease(jax, holder='jax:1:a', lease_seconds=30)
        assert theirs.ensure() is True
        mine = LeaderLease(port, holder='port:2:b', lease_seconds=30)
        assert mine.ensure() is False
        # the JAX leader's graceful release hands over at epoch 2
        assert theirs.release() is True
        assert mine.ensure() is True and mine.epoch == 2
        assert JaxLeaseProvider(jax).current().holder == 'port:2:b'

    def test_port_leader_blocks_jax_and_fences_it(self, shared):
        jax, port = shared
        mine = LeaderLease(port, holder='port:1:a', lease_seconds=30)
        assert mine.ensure() is True
        theirs = JaxLeaderLease(jax, holder='jax:2:b', lease_seconds=30)
        assert theirs.ensure() is False
        # a JAX zombie at a stale epoch cannot write a fenced table
        from mlcomp_tpu.db.fencing import FencedSession as JaxFenced
        from mlcomp_tpu.db.fencing import FenceLostError as JaxFenceLost
        from mlcomp_tpu.db.providers import QueueProvider as JaxQueue
        from mlcomp_tpu.server.ha import StaticLease as JaxStatic
        with pytest.raises(JaxFenceLost):
            JaxQueue(JaxFenced(jax, JaxStatic(0))).enqueue(
                'q', {'action': 'execute', 'task_id': 1})
        _expire_lease(port)
        assert theirs.ensure() is True and theirs.epoch == 2
        mine._renew_deadline = 0.0
        assert mine.ensure() is False and mine.demotions == 1


class TestPromotionLatency:
    def test_explicit_release_promotes_via_event(self, session):
        """A standby parked on the lease channel in the same process
        promotes at once when the leader releases."""
        leader = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert leader.ensure() is True
        standby = LeaderLease(session, holder='s:2:b', lease_seconds=30)
        assert standby.ensure() is False
        promoted = {}

        def promote():
            t0 = time.monotonic()
            while time.monotonic() < t0 + 10:
                if standby.ensure():
                    promoted['s'] = time.monotonic() - t0
                    return
                standby.wait_standby(5.0)

        thread = threading.Thread(target=promote, daemon=True)
        thread.start()
        time.sleep(0.1)
        leader.release()
        thread.join(10)
        assert promoted.get('s') is not None and promoted['s'] < 2.0

    def test_expiry_promotes_within_window(self, session):
        leader = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert leader.ensure() is True
        standby = LeaderLease(session, holder='s:2:b', lease_seconds=30)
        assert standby.ensure() is False
        _expire_lease(session)
        assert standby.ensure() is True and standby.epoch == 2
        leader._renew_deadline = 0.0
        assert leader.ensure() is False
        assert leader.epoch is None and leader.demotions == 1

    def test_standby_retries_at_a_third_of_the_window(self, session):
        lease = LeaderLease(session, holder='s:2:b', lease_seconds=0.9)
        assert lease.standby_wait_s == pytest.approx(0.3)

    def test_loop_stop_releases_lease_same_tick(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        builder = SupervisorBuilder(session=session, lease=lease)
        loop = SupervisorLoop(builder, interval=30.0, lease=lease)
        loop.stop()
        assert SupervisorLeaseProvider(session).current().holder is None
        rival = LeaderLease(session, holder='r:2:b', lease_seconds=30)
        assert rival.ensure() is True


class TestFencing:
    def test_fence_statement_rewrites(self):
        sql, params, fenced = fence_statement(
            'UPDATE task SET "status"=? WHERE "id"=?', (3, 7), 5)
        assert fenced and params == (3, 7, 5)
        assert sql.endswith('AND ' + FENCE_PREDICATE)
        sql, params, fenced = fence_statement(
            "INSERT INTO queue_message (queue, payload, status, "
            "created) VALUES (?, ?, 'pending', ?)", ('q', 'p', 't'), 5)
        assert fenced and 'SELECT ?, ?' in sql and 'VALUES' not in sql
        sql, _, fenced = fence_statement(
            "UPDATE queue_message SET status='claimed' WHERE id=? "
            "RETURNING id", (1,), 5)
        assert fenced and sql.endswith('RETURNING id')
        for stmt in ('INSERT INTO metric (name) VALUES (?)',
                     'SELECT * FROM task', 'UPDATE computer SET cpu=?'):
            assert fence_statement(stmt, (), 5)[2] is False

    def test_jax_rewrites_alike(self):
        from mlcomp_tpu.db.fencing import (
            fence_statement as jax_fence_statement,
        )
        for stmt in ('UPDATE task SET "status"=? WHERE "id"=?',
                     'DELETE FROM queue_message WHERE id=?',
                     'INSERT INTO task (name) VALUES (?)',
                     'INSERT INTO task (name) SELECT ? WHERE 1',
                     "UPDATE queue_message SET status='claimed' "
                     "WHERE id=? RETURNING id",
                     'UPDATE computer SET cpu=?'):
            assert fence_statement(stmt, (1,), 4) == \
                jax_fence_statement(stmt, (1,), 4)

    def test_zombie_write_rejected_after_newer_epoch(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        task = _add_task(session)
        fenced = FencedSession(session, StaticLease(1))
        TaskProvider(fenced).change_status(task, TaskStatus.Queued)
        _expire_lease(session)
        rival = LeaderLease(session, holder='r:2:b', lease_seconds=30)
        assert rival.ensure() is True
        before = fence_rejections()
        stale_view = TaskProvider(fenced).by_id(task.id)
        with pytest.raises(FenceLostError):
            TaskProvider(fenced).fail_with_reason(stale_view, 'worker-lost')
        assert fence_rejections() == before + 1
        fresh = TaskProvider(session).by_id(task.id)
        assert fresh.status == int(TaskStatus.Queued)
        assert fresh.failure_reason is None
        with pytest.raises(FenceLostError):
            QueueProvider(fenced).enqueue(
                'q', {'action': 'execute', 'task_id': task.id})
        assert QueueProvider(session).pending('q') == []

    def test_non_leader_wrapper_never_writes(self, session):
        fenced = FencedSession(session, StaticLease(None))
        with pytest.raises(FenceLostError):
            _add_task(fenced)
        assert TaskProvider(session).count() == 0

    def test_unfenced_tables_pass_through(self, session):
        fenced = FencedSession(session, StaticLease(None))
        MetricProvider(fenced).add_many(
            [(None, 'x', 'gauge', None, 1.0, now(), 'test', None)])
        assert session.query_one(
            "SELECT COUNT(*) AS c FROM metric WHERE name='x'")['c'] == 1

    def test_batch_insert_fenced_loudly(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        zombie = FencedSession(session, StaticLease(1))
        _expire_lease(session)
        rival = LeaderLease(session, holder='r:2:b', lease_seconds=30)
        assert rival.ensure() is True
        with pytest.raises(FenceLostError):
            QueueProvider(zombie).enqueue_many([
                ('q', {'action': 'execute', 'task_id': i})
                for i in range(3)])
        assert session.query_one(
            'SELECT COUNT(*) AS c FROM queue_message')['c'] == 0
        live = FencedSession(session, rival)
        assert QueueProvider(live).enqueue_many([
            ('q', {'action': 'execute', 'task_id': i})
            for i in range(3)]) == 3

    def test_benign_conditional_loss_not_a_fence_error(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        qp = QueueProvider(FencedSession(session, lease))
        msg = qp.enqueue('q', {'action': 'execute', 'task_id': 1})
        assert qp.claim(['q'], 'w1') is not None
        assert qp.revoke(msg) is False

    def test_every_tick_write_to_a_fenced_table_is_fenced(self, session):
        """Record every statement the port's supervisor issues through a
        tick that dispatches, reclaims a dead worker's lease and retries
        a transient failure: each mutation of a fenced table carries the
        fence predicate (an unfenced one would double-dispatch after a
        failover)."""
        _add_computer(session, 'h1')
        queued = _add_task(session, 'q')
        dead = QueueProvider(session).enqueue(
            'gone_default', {'action': 'execute', 'task_id': queued.id})
        session.execute(
            "UPDATE queue_message SET status='claimed', claimed_by="
            "'gone:0', claimed_at=? WHERE id=?",
            (now() - datetime.timedelta(seconds=600), dead))
        session.execute('UPDATE task SET status=?, queue_id=?, '
                        "computer_assigned='gone' WHERE id=?",
                        (int(TaskStatus.Queued), dead, queued.id))
        _add_task(session, 'placed')
        failed = _add_task(session, 'failed')
        session.execute(
            "UPDATE task SET status=?, failure_reason='preempted', "
            "next_retry_at=? WHERE id=?",
            (int(TaskStatus.Failed),
             now() - datetime.timedelta(seconds=5), failed.id))
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        seen = []
        original = session.execute

        def recording(sql, params=()):
            seen.append(sql)
            return original(sql, params)

        session.execute = recording
        try:
            sup = SupervisorBuilder(
                session=session, lease=lease,
                recovery_config=RecoveryConfig(lease_seconds=60))
            sup.build()
        finally:
            del session.execute
        writes = [sql for sql in seen
                  if fence_statement(sql.replace(' AND ' + FENCE_PREDICATE,
                                                 '').replace(
                      ' WHERE ' + FENCE_PREDICATE, ''), (), 1)[2]]
        assert len(writes) >= 8
        assert all(FENCE_PREDICATE in sql for sql in writes), [
            sql for sql in writes if FENCE_PREDICATE not in sql]
        tables = {sql.split()[2] if sql.startswith(('INSERT', 'DELETE'))
                  else sql.split()[1] for sql in writes}
        assert tables <= FENCED_TABLES and {'task', 'queue_message'} <= \
            tables
        aux = sup.aux
        assert aux['dispatched'] and aux['lease_reclaimed'] and \
            aux['retried']


class TestCrashConsistentDispatch:
    def _leader_builder(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        sup = SupervisorBuilder(session=session, lease=lease)
        sup.create_base()
        return sup

    def test_sweep_repairs_torn_dispatch_exactly_once(self, session):
        _add_computer(session)
        task = _add_task(session, computer_assigned='h1',
                         cores_assigned=json.dumps([0]))
        msg = QueueProvider(session).enqueue(
            'h1_default', {'action': 'execute', 'task_id': task.id})
        sup = self._leader_builder(session)
        out = sup.reconcile_dispatches()
        assert out['adopted'] == [{'task': task.id, 'msg': msg}]
        task = TaskProvider(session).by_id(task.id)
        assert task.status == int(TaskStatus.Queued)
        assert task.queue_id == msg
        assert not any(sup.reconcile_dispatches().values())

    def test_sweep_rolls_back_orphan_message(self, session):
        _add_computer(session)
        task = _add_task(session)
        TaskProvider(session).change_status(task, TaskStatus.Stopped)
        msg = QueueProvider(session).enqueue(
            'h1_default', {'action': 'execute', 'task_id': task.id})
        ghost = QueueProvider(session).enqueue(
            'h1_default', {'action': 'execute', 'task_id': 99999})
        out = self._leader_builder(session).reconcile_dispatches()
        assert sorted(out['revoked']) == sorted([msg, ghost])
        statuses = {r['id']: r['status'] for r in session.query(
            'SELECT id, status FROM queue_message')}
        assert statuses[msg] == statuses[ghost] == 'revoked'

    def test_sweep_requeues_queued_task_with_dead_message(self, session):
        _add_computer(session)
        task = _add_task(session, computer_assigned='h1', queue_id=424242)
        TaskProvider(session).change_status(task, TaskStatus.Queued)
        out = self._leader_builder(session).reconcile_dispatches()
        assert out['requeued'] == [task.id]
        task = TaskProvider(session).by_id(task.id)
        assert task.status == int(TaskStatus.NotRan)
        assert task.queue_id is None

    def test_promotion_runs_sweep_and_counts_failover(self, session):
        _add_computer(session)
        task = _add_task(session, computer_assigned='h1',
                         cores_assigned=json.dumps([0]))
        QueueProvider(session).enqueue(
            'h1_default', {'action': 'execute', 'task_id': task.id})
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        sup = SupervisorBuilder(session=session, lease=lease)
        loop = SupervisorLoop(sup, interval=0.05, lease=lease)
        loop._stop_evt.set()        # gate inline, no parking
        assert loop._ha_gate() is True
        assert loop.promotions == 1
        assert (sup.aux.get('dispatch_reconciled') or {}).get('adopted')
        rows = session.query(
            "SELECT step, tags FROM metric WHERE name='supervisor.failover'")
        assert len(rows) == 1
        assert json.loads(rows[0]['tags'])['first_boot'] == 1

    def test_reacquire_after_fence_demotion_repromotes(self, session):
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        sup = SupervisorBuilder(session=session, lease=lease)
        loop = SupervisorLoop(sup, interval=0.05, lease=lease)
        loop._stop_evt.set()
        assert loop._ha_gate() is True and loop.promotions == 1
        _expire_lease(session)
        rival = LeaderLease(session, holder='r:2:b', lease_seconds=30)
        assert rival.ensure() is True
        loop._fence_demote()
        assert loop._was_leader is False and loop.demotions == 1
        rival.release()
        assert loop._ha_gate() is True
        assert loop.promotions == 2
        assert len(session.query(
            "SELECT id FROM metric WHERE name='supervisor.failover'")) == 2

    def test_zombie_tick_demotes_and_counts_the_fenced_write(self, session):
        """A leader whose epoch moved under it: its next tick's first
        fenced write raises, the loop demotes, and its next good tick
        counts the rejection into the tick recorder's
        ``supervisor.fenced_writes``, which lands at the recorder's
        flush."""
        _add_computer(session)
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        sup = SupervisorBuilder(session=session, lease=lease)
        loop = SupervisorLoop(sup, interval=0.05, lease=lease)
        loop._stop_evt.set()
        assert loop._ha_gate() is True
        _add_task(session)
        _expire_lease(session)
        rival = LeaderLease(session, holder='r:2:b', lease_seconds=30)
        assert rival.ensure() is True
        with pytest.raises(FenceLostError):
            sup.build()
        loop._fence_demote()
        assert lease.epoch is None and loop.demotions == 1
        assert session.query_one('SELECT status FROM task')['status'] == \
            int(TaskStatus.NotRan)
        rival.release()
        assert loop._ha_gate() is True
        sup.build()
        sup.telemetry.flush()
        assert session.query_one(
            "SELECT SUM(value) AS n FROM metric "
            "WHERE name='supervisor.fenced_writes'")['n'] >= 1.0

    def test_dispatch_order_prestamps_placement(self, session,
                                                monkeypatch):
        """By the time the execute message exists, the task row carries
        its placement: killed between the halves, the torn row is
        adoptable."""
        _add_computer(session)
        task = _add_task(session)
        seen = {}
        original = QueueProvider.enqueue

        def probe(self, queue, payload):
            seen.update(dict(session.query_one(
                'SELECT computer_assigned, status, queue_id FROM task '
                'WHERE id=?', (task.id,))))
            return original(self, queue, payload)

        monkeypatch.setattr(QueueProvider, 'enqueue', probe)
        lease = LeaderLease(session, holder='l:1:a', lease_seconds=30)
        assert lease.ensure() is True
        SupervisorBuilder(session=session, lease=lease).build()
        assert seen == {'computer_assigned': 'h1',
                        'status': int(TaskStatus.NotRan), 'queue_id': None}


# ------------------------------------------------- tick parity under HA
class HaTwin(tick.Twin):
    """``tick.Twin`` whose builders each hold their package's lease."""

    kill_stamp = {'epoch': 1}

    def start(self):
        super().start()
        jax_lease = JaxLeaderLease(self.jax, holder='jax:1:a',
                                   lease_seconds=300)
        port_lease = LeaderLease(self.port, holder='port:1:a',
                                 lease_seconds=300)
        assert jax_lease.ensure() and port_lease.ensure()
        self.jax_sup = JaxSupervisor(
            session=self.jax, recovery_config=JaxRecovery(**tick.RECOVERY),
            lease=jax_lease)
        self.port_sup = SupervisorBuilder(
            session=self.port, recovery_config=RecoveryConfig(**tick.RECOVERY),
            lease=port_lease)
        assert isinstance(self.port_sup.session, FencedSession)


SCENARIOS = [
    tick.test_placement_and_no_live_queue,
    tick.test_cpu_memory_gate_pin_and_packing_order,
    tick.test_waiting_and_failed_dependencies,
    tick.test_parent_aggregation_with_a_failed_child,
    tick.test_priority_and_aging_order,
    tick.test_transient_failure_retried_after_backoff_elsewhere,
    tick.test_retry_exhausted_raises_one_alert,
    tick.test_lease_reclaim_once_then_strand_sweep,
    tick.test_preflight_blocks_a_dag_that_skipped_the_gate,
]


@pytest.mark.parametrize('scenario', SCENARIOS,
                         ids=lambda f: f.__name__[len('test_'):])
def test_tick_parity_with_ha(tmp_path, scenario):
    twin = HaTwin(tmp_path)
    try:
        scenario(twin)
    finally:
        twin.close()

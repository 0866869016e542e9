"""Serving fleets on the port (``server/fleet.py``, the ``serve_replica``
executor, the serving heartbeat, ``fleets``) against the JAX package's,
on the CPU.

- The reconciler: every scenario of ``tests/test_fleet.py``'s
  ``TestReconciler``, ``TestRollingSwap``, ``TestStartSwapRace`` and
  ``TestGatewayDbRefresh`` on twin sqlite DBs (``Twin`` of
  ``tests/test_torch_port_supervisor.py``): each package's operations
  on its own copy, then ``SupervisorBuilder.build()`` of each. After
  every tick both DBs hold the same ``serve_fleet``, ``serve_replica``
  and task rows (status, placement, ``retry_exclude`` and the rest of
  the replica's ``additional_info``), the same ``fleet.*`` metric
  events, queue messages, alerts and decision trace. The probe is
  injected (``FleetConfig(probe_interval_s=0.0, unhealthy_after=2)``, as
  JAX's tests run it): no sleeps.
- The ``serve_replica`` executor serving a 2-layer LM export (d_model
  64) written by JAX's ``export_model``: it marks its endpoint, passes
  ``http_probe``, beats ``last_activity`` and answers ``/predict`` as
  JAX's ``ModelServer`` does on the same export (plain, and with
  ``quantize='int8'``); a replica of an export without ``input_shape``,
  or asked for CUDA where there is none, fails.
- The heartbeat: the auxiliary row while serving, the serving spans of a
  traced request flushed, the row gone after the drain; ``serve
  --register``.
- ``fleets --json`` and ``mlcomp_fleet_replicas`` against JAX's on the
  same rows.
"""

import datetime
import importlib
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from mlcomp_tpu.db.enums import TaskStatus as JaxStatus
from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu.utils.io import yaml_load as jax_yaml_load
from mlcomp_tpu.utils.misc import now
from mlcomp_tpu_torch import TOKEN
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.server.supervisor import SupervisorBuilder
from mlcomp_tpu_torch.utils.io import yaml_load
from tests.test_torch_port_int8 import LM_SPEC, _row_error
from tests.test_torch_port_serve import F32_TOL
from tests.test_torch_port_supervisor import Twin

JAX = SimpleNamespace(
    fleet=importlib.import_module('mlcomp_tpu.server.fleet'),
    gateway=importlib.import_module('mlcomp_tpu.server.gateway'),
    providers=importlib.import_module('mlcomp_tpu.db.providers'),
    status=JaxStatus)
PORT = SimpleNamespace(
    fleet=importlib.import_module('mlcomp_tpu_torch.server.fleet'),
    gateway=importlib.import_module('mlcomp_tpu_torch.server.gateway'),
    providers=importlib.import_module('mlcomp_tpu_torch.db.providers'),
    status=TaskStatus)

#: the rows' clock columns: each package stamps its own now()
CLOCK_COLUMNS = ('created', 'updated', 'last_probe', 'last_ok',
                 'swap_started', 'last_activity', 'started', 'finished')


class FleetTwin(Twin):
    """``Twin`` with both supervisors carrying the same fleet config and
    the same injected probe (``health``: url -> bool, healthy unless
    set)."""

    def start(self, **fleet_kw):
        super().start()
        self.health = {}
        probe = lambda url: self.health.get(url, True)   # noqa: E731
        self.jax_sup = JaxSupervisor(
            session=self.jax, recovery_config=self.jax_sup.recovery_config,
            fleet_config=JAX.fleet.FleetConfig(
                probe_interval_s=0.0, unhealthy_after=2, **fleet_kw),
            fleet_probe=probe)
        self.port_sup = SupervisorBuilder(
            session=self.port, recovery_config=self.port_sup.recovery_config,
            fleet_config=PORT.fleet.FleetConfig(
                probe_interval_s=0.0, unhealthy_after=2, **fleet_kw),
            fleet_probe=probe)

    def each(self, fn):
        """``fn(package, session)`` for JAX on its DB and the port on its
        own; both results."""
        return fn(JAX, self.jax), fn(PORT, self.port)

    def tick(self):
        st = super().tick()
        theirs, mine = fleet_state(self.jax), fleet_state(self.port)
        assert mine == theirs
        return {**st, **mine}


def _rows(session, sql):
    return [{k: r[k] for k in r.keys() if k not in CLOCK_COLUMNS}
            for r in session.query(sql)]


def fleet_state(session) -> dict:
    tasks = []
    for r in session.query(
            "SELECT * FROM task WHERE executor='serve_replica' ORDER BY id"):
        row = {k: r[k] for k in ('id', 'name', 'status', 'executor', 'type',
                                 'cores', 'cores_max', 'cpu', 'memory',
                                 'dag', 'priority', 'project',
                                 'computer_assigned', 'cores_assigned',
                                 'failure_reason')}
        row['info'] = jax_yaml_load(r['additional_info'])
        tasks.append(row)
    events = [(r['task'], r['name'], r['kind'], r['value'],
               json.loads(r['tags']))
              for r in session.query(
                  "SELECT * FROM metric WHERE name LIKE 'fleet.%' "
                  "ORDER BY id")]
    aux = session.query_one(
        "SELECT data FROM auxiliary WHERE name='supervisor'")
    return {'fleets': _rows(session, 'SELECT * FROM serve_fleet ORDER BY id'),
            'replicas': _rows(session,
                              'SELECT * FROM serve_replica ORDER BY id'),
            'replica_tasks': tasks, 'events': events,
            'dags': [tuple(r) for r in session.query(
                "SELECT id, name, config FROM dag WHERE name LIKE 'fleet_%'")],
            'fleet_aux': json.loads(aux['data']).get('fleets')
            if aux else None}


@pytest.fixture()
def twin(tmp_path):
    t = FleetTwin(tmp_path)
    yield t
    t.close()


def bring_up(pkg, session, fleet_id, port_of=lambda r: 9000 + r.id):
    """Play the worker's part for every starting replica: claim the
    dispatch, mark InProgress, bind a (fake) endpoint."""
    p = pkg.providers
    rp, tp, qp = (p.ReplicaProvider(session), p.TaskProvider(session),
                  p.QueueProvider(session))
    for replica in rp.of_fleet(fleet_id, states=('starting',)):
        task = tp.by_id(replica.task)
        if task is None or task.status != int(pkg.status.Queued):
            continue
        qp.claim([f'{task.computer_assigned}_default'],
                 f'{task.computer_assigned}:0')
        tp.change_status(task, pkg.status.InProgress)
        rp.mark_endpoint(replica.id, task.computer_assigned, port_of(replica),
                         f'http://127.0.0.1:{port_of(replica)}')


def _ago(seconds):
    return now() - datetime.timedelta(seconds=seconds)


def expire_probes(twin):
    twin.both('UPDATE serve_replica SET last_probe=?', (_ago(3600),))


def _fleet(twin, name='f'):
    return twin.each(lambda pkg, s: pkg.providers.FleetProvider(s)
                     .by_name(name))


def _create(twin, name='f', model='m', **kw):
    fleets = twin.each(lambda pkg, s: pkg.fleet.create_fleet(
        s, name, model, **kw))
    assert fleets[0].id == fleets[1].id
    return fleets[1].id


def _both_raise(twin, fn, match):
    for pkg, session in ((JAX, twin.jax), (PORT, twin.port)):
        with pytest.raises(ValueError, match=match):
            fn(pkg, session)


def _by_id(rows):
    return {r['id']: r for r in rows}


# ------------------------------------------------------------- reconciler
def test_spawn_to_desired_through_placement(twin):
    for host in ('h1', 'h2', 'h3'):
        twin.computer(host)
    twin.start()
    fid = _create(twin, desired=3)
    st = twin.tick()
    assert len(st['replicas']) == 3
    assert all(t['status'] == int(TaskStatus.Queued)
               for t in st['replica_tasks'])
    assert len({t['computer_assigned'] for t in st['replica_tasks']}) == 3
    serve = st['replica_tasks'][0]['info']['serve']
    assert (serve['fleet'], serve['fleet_name'], serve['model']) == (
        fid, 'f', 'm')
    assert st['fleet_aux']['spawned'] == {'f': [r['id'] for r in
                                                st['replicas']]}
    st = twin.tick()                    # steady state: no spawn storm
    assert len(st['replicas']) == 3


def test_probe_failure_respawns_exactly_once_excluding_host(twin):
    for host in ('h1', 'h2', 'h3'):
        twin.computer(host)
    twin.start()
    fid = _create(twin, desired=2)
    twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    st = twin.tick()
    assert [r['state'] for r in st['replicas']] == ['healthy'] * 2
    victim = st['replicas'][0]
    twin.health[victim['url']] = False
    for _ in range(3):
        expire_probes(twin)
        st = twin.tick()
    rows = _by_id(st['replicas'])
    assert (rows[victim['id']]['state'],
            rows[victim['id']]['failure_reason']) == (
        'dead', 'replica-unhealthy')
    tasks = _by_id(st['replica_tasks'])
    assert (tasks[victim['task']]['status'],
            tasks[victim['task']]['failure_reason']) == (
        int(TaskStatus.Failed), 'replica-unhealthy')
    (spawned,) = [r for r in rows.values()
                  if r['respawned_from'] == victim['id']]
    new = tasks[spawned['task']]
    assert new['info']['retry_exclude'] == [
        tasks[victim['task']]['computer_assigned']]
    assert new['computer_assigned'] != \
        tasks[victim['task']]['computer_assigned']
    assert [e[1:] for e in st['events']] == [
        ('fleet.respawn', 'counter', float(spawned['id']),
         {'fleet': 'f', 'reason': 'replica-unhealthy'})]
    for _ in range(3):                  # exactly once
        expire_probes(twin)
        st = twin.tick()
    assert len(st['replicas']) == 3


def test_bound_but_never_healthy_replica_is_replaced(twin):
    twin.computer('h1')
    twin.computer('h2')
    twin.start()
    fid = _create(twin, desired=1)
    st = twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    replica = twin.port.query_one('SELECT * FROM serve_replica')
    twin.health[replica['url']] = False
    for _ in range(4):
        expire_probes(twin)
        st = twin.tick()
    rows = _by_id(st['replicas'])
    assert (rows[replica['id']]['state'],
            rows[replica['id']]['failure_reason']) == (
        'dead', 'replica-unhealthy')
    assert any(r['respawned_from'] == replica['id'] for r in rows.values())


def test_heartbeat_silence_is_worker_lost(twin):
    twin.computer('h1')
    twin.computer('h2')
    twin.start(replica_silence_s=60)
    fid = _create(twin, desired=1)
    twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    st = twin.tick()
    task = st['replica_tasks'][0]['id']
    twin.both('UPDATE task SET last_activity=? WHERE id=?', (_ago(300), task))
    st = twin.tick()
    first = st['replicas'][0]
    assert (first['state'], first['failure_reason']) == ('dead',
                                                         'worker-lost')
    assert _by_id(st['replica_tasks'])[task]['failure_reason'] == \
        'worker-lost'


def test_task_verdict_absorbed(twin):
    twin.computer('h1')
    twin.computer('h2')
    twin.start()
    _create(twin, desired=1)
    st = twin.tick()
    task = st['replica_tasks'][0]['id']
    twin.each(lambda pkg, s: pkg.providers.TaskProvider(s).fail_with_reason(
        pkg.providers.TaskProvider(s).by_id(task), 'lease-expired'))
    st = twin.tick()
    assert (st['replicas'][0]['state'],
            st['replicas'][0]['failure_reason']) == ('dead', 'lease-expired')
    assert len(st['replicas']) == 2     # a replacement minted


def test_scale_down_is_not_a_respawn_storm(twin):
    twin.computer('h1')
    twin.start()
    _create(twin, desired=2, cores=1)
    twin.tick()

    def scale(pkg, s):
        fleet = pkg.providers.FleetProvider(s).by_name('f')
        fleet.desired = 0
        pkg.providers.FleetProvider(s).touch(fleet, ['desired'])

    twin.each(scale)
    st = twin.tick()
    assert len(st['replicas']) == 2


def test_stop_fleet_kills_replicas(twin):
    twin.computer('h1')
    twin.start()
    _create(twin, desired=2)
    twin.tick()
    twin.each(lambda pkg, s: pkg.fleet.stop_fleet(
        s, pkg.providers.FleetProvider(s).by_name('f')))
    st = twin.tick()
    assert st['fleets'][0]['status'] == 'stopped'
    assert {r['state'] for r in st['replicas']} == {'dead'}
    assert {t['status'] for t in st['replica_tasks']} == {
        int(TaskStatus.Stopped)}
    st = twin.tick()                    # stopped: not reconciled
    assert {r['state'] for r in st['replicas']} == {'dead'}


def test_a_replica_spawned_across_a_stop_is_retired(twin):
    """A tick that read the fleet active just before ``stop_fleet``
    landed respawns the replicas the stop retired. JAX's reconciler never
    visits the stopped fleet again, so they live on (a fault of the
    reference); the port's next tick stops them as the stop does."""
    twin.computer('h1')
    twin.start()
    _create(twin, desired=2)
    twin.tick()
    stale = _fleet(twin)                 # read by the racing tick
    twin.each(lambda pkg, s: pkg.fleet.stop_fleet(
        s, pkg.providers.FleetProvider(s).by_name('f')))
    twin.jax_sup.fleet_reconciler._reconcile(stale[0])
    twin.port_sup.fleet_reconciler._reconcile(stale[1])
    theirs, mine = fleet_state(twin.jax), fleet_state(twin.port)
    assert mine == theirs
    assert [r['state'] for r in mine['replicas']] == ['dead'] * 2 + \
        ['starting'] * 2
    twin.jax_sup.build()
    twin.port_sup.build()
    theirs, mine = fleet_state(twin.jax), fleet_state(twin.port)
    assert [r['state'] for r in theirs['replicas']] == ['dead'] * 2 + \
        ['starting'] * 2
    assert [(r['state'], r['failure_reason']) for r in mine['replicas']] \
        == [('dead', 'fleet-stopped')] * 4
    assert {t['status'] for t in mine['replica_tasks']} == {
        int(TaskStatus.Stopped)}
    assert mine['fleets'][0]['status'] == 'stopped'


# ------------------------------------------------------------- the swap
def _warm(twin, desired=2):
    for host in ('h1', 'h2'):
        twin.computer(host)
    twin.start(drain_grace_s=0.0)
    fid = _create(twin, model='m_v1', desired=desired)
    twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    twin.tick()
    return fid


def _swap(pkg, session, model='m_v2'):
    return pkg.fleet.start_swap(
        session, pkg.providers.FleetProvider(session).by_name('f'), model)


def test_flip_after_warmup_then_drain(twin):
    fid = _warm(twin)
    twin.each(_swap)
    st = twin.tick()                    # generation 2 staged
    gen2 = [r for r in st['replicas'] if r['generation'] == 2]
    assert len(gen2) == 2 and st['fleets'][0]['generation'] == 1
    assert _by_id(st['replica_tasks'])[gen2[0]['task']]['info'][
        'serve']['model'] == 'm_v2'
    expire_probes(twin)
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    st = twin.tick()                    # warm: the flip
    fleet = st['fleets'][0]
    assert (fleet['generation'], fleet['model'], fleet['status'],
            fleet['target_generation']) == (2, 'm_v2', 'active', None)
    assert {r['state'] for r in st['replicas']
            if r['generation'] == 1} == {'draining'}
    st = twin.tick()                    # drain grace 0: retired
    tasks = _by_id(st['replica_tasks'])
    assert all(tasks[r['task']]['status'] >= int(TaskStatus.Failed)
               for r in st['replicas'] if r['generation'] == 1)
    st = twin.tick()
    assert {(r['state'], r['failure_reason']) for r in st['replicas']
            if r['generation'] == 1} == {('dead', 'drained')}
    assert [e[1:] for e in st['events']] == [
        ('fleet.swap', 'counter', 2.0,
         {'fleet': 'f', 'outcome': 'completed'})]


def test_failed_warmup_rolls_back(twin):
    fid = _warm(twin)
    twin.each(_swap)
    st = twin.tick()
    for r in st['replicas']:
        if r['generation'] == 2:
            twin.health[f'http://127.0.0.1:{9000 + r["id"]}'] = False
    twin.both('UPDATE serve_fleet SET swap_started=? WHERE id=?',
              (_ago(3600), fid))
    st = twin.tick()
    fleet = st['fleets'][0]
    assert (fleet['generation'], fleet['model'], fleet['status'],
            fleet['target_generation']) == (1, 'm_v1', 'active', None)
    assert {(r['state'], r['failure_reason']) for r in st['replicas']
            if r['generation'] == 2} == {('dead', 'swap-rollback')}
    assert st['alerts'] == [('swap-rollback', None, 'critical', 'open')]
    assert [e[1:] for e in st['events']] == [
        ('fleet.swap', 'counter', 2.0,
         {'fleet': 'f', 'outcome': 'rollback'})]
    assert sum(r['state'] == 'healthy' for r in st['replicas']) == 2


def test_double_swap_rejected(twin):
    _warm(twin)
    twin.each(_swap)
    _both_raise(twin, lambda pkg, s: _swap(pkg, s, 'm_v3'),
                'already swapping')
    twin.tick()


# ------------------------------------------------------ the swap's race
def test_second_stale_swapper_loses(twin):
    twin.start()
    _create(twin, 'swapf', 'model_v1', desired=1)
    for pkg, s in ((JAX, twin.jax), (PORT, twin.port)):
        fp = pkg.providers.FleetProvider(s)
        stale_a, stale_b = fp.by_name('swapf'), fp.by_name('swapf')
        pkg.fleet.start_swap(s, stale_a, 'model_v2')
        with pytest.raises(ValueError, match='swapping'):
            pkg.fleet.start_swap(s, stale_b, 'model_v3')
        assert (stale_b.status, stale_a.target_generation) == (
            'active', 2)
    st = fleet_state(twin.port)
    assert st == fleet_state(twin.jax)
    assert (st['fleets'][0]['target_model'],
            st['fleets'][0]['target_generation']) == ('model_v2', 2)


def test_stale_swap_after_completed_swap_refused(twin):
    twin.start()
    _create(twin, 'genf', 'model_v1', desired=1)
    stale = _fleet(twin, 'genf')
    twin.both("UPDATE serve_fleet SET generation=2, model='model_v2' "
              "WHERE name='genf'")
    for (pkg, s), fleet in zip(((JAX, twin.jax), (PORT, twin.port)), stale):
        with pytest.raises(ValueError, match='moved to generation 2'):
            pkg.fleet.start_swap(s, fleet, 'model_v3')
    twin.each(lambda pkg, s: pkg.fleet.start_swap(
        s, pkg.providers.FleetProvider(s).by_name('genf'), 'model_v3'))
    st = fleet_state(twin.port)
    assert st == fleet_state(twin.jax)
    assert st['fleets'][0]['target_generation'] == 3


def test_swap_on_stopped_fleet_refused(twin):
    twin.start()
    _create(twin, 'stopf', 'model_v1', desired=0)
    twin.each(lambda pkg, s: pkg.fleet.stop_fleet(
        s, pkg.providers.FleetProvider(s).by_name('stopf')))
    _both_raise(twin, lambda pkg, s: pkg.fleet.start_swap(
        s, pkg.providers.FleetProvider(s).by_name('stopf'), 'model_v2'),
        'stopped')
    st = fleet_state(twin.port)
    assert st == fleet_state(twin.jax)
    assert st['fleets'][0]['target_model'] is None


def test_duplicate_fleet_and_bad_priority_refused(twin):
    twin.start()
    _create(twin)
    _both_raise(twin, lambda pkg, s: pkg.fleet.create_fleet(s, 'f', 'm'),
                'already exists')
    for pkg, s in ((JAX, twin.jax), (PORT, twin.port)):
        with pytest.raises(ValueError):
            pkg.fleet.create_fleet(s, 'g', 'm', priority='bogus')
    assert fleet_state(twin.port) == fleet_state(twin.jax)


# -------------------------------------------------------- gateway refresh
def test_gateway_routes_follow_the_active_generation(twin):
    """Each package's gateway refreshed from its own DB routes to the
    same replicas: the healthy ones of the active generation, none of a
    stopped fleet."""
    twin.computer('h1')
    twin.computer('h2')
    twin.start()
    fid = _create(twin, desired=1)
    twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    twin.tick()
    gateways = [pkg.gateway.FleetGateway(port=0, session=s, refresh_s=3600)
                for pkg, s in ((JAX, twin.jax), (PORT, twin.port))]

    def routes():
        out = []
        for gw in gateways:
            gw.refresh_from_db()
            out.append({name: (r.generation, [(b.url, b.replica_id)
                                              for b in r.backends])
                        for name, r in gw.routes.items()})
        assert out[0] == out[1]
        return out[1]

    (replica,) = fleet_state(twin.port)['replicas']
    assert routes() == {'f': (1, [(replica['url'], replica['id'])])}
    twin.both('UPDATE serve_replica SET url=? WHERE id=?',
              ('http://127.0.0.1:9999', replica['id']))
    assert routes() == {'f': (1, [('http://127.0.0.1:9999',
                                   replica['id'])])}
    twin.each(lambda pkg, s: pkg.fleet.stop_fleet(
        s, pkg.providers.FleetProvider(s).by_name('f')))
    assert routes() == {}


# ------------------------------------------------------- under the lease
class FleetHaTwin(FleetTwin):
    """``FleetTwin`` whose supervisors each hold their package's leader
    lease: every reconciler write rides the epoch fence."""

    def start(self, **fleet_kw):
        from mlcomp_tpu.server.ha import LeaderLease as JaxLeaderLease
        from mlcomp_tpu_torch.db.fencing import FencedSession
        from mlcomp_tpu_torch.server.ha import LeaderLease
        super().start(**fleet_kw)
        jax_lease = JaxLeaderLease(self.jax, holder='jax:1:a',
                                   lease_seconds=300)
        port_lease = LeaderLease(self.port, holder='port:1:a',
                                 lease_seconds=300)
        assert jax_lease.ensure() and port_lease.ensure()
        for name, cls, lease in (('jax_sup', JaxSupervisor, jax_lease),
                                 ('port_sup', SupervisorBuilder,
                                  port_lease)):
            old = getattr(self, name)
            setattr(self, name, cls(
                session=old.raw_session,
                recovery_config=old.recovery_config,
                fleet_config=old.fleet_config,
                fleet_probe=old.fleet_probe, lease=lease))
        assert isinstance(self.port_sup.session, FencedSession)


@pytest.mark.parametrize('scenario', [
    'test_probe_failure_respawns_exactly_once_excluding_host',
    'test_stop_fleet_kills_replicas', 'test_flip_after_warmup_then_drain',
    'test_failed_warmup_rolls_back'])
def test_fleet_tick_parity_with_ha(tmp_path, scenario):
    twin = FleetHaTwin(tmp_path)
    try:
        globals()[scenario](twin)
    finally:
        twin.close()


def test_zombie_reconciler_writes_nothing(tmp_path):
    """A leader whose lease a rival took: its tick's first fleet write is
    fenced off, ``FenceLostError`` ends the tick, and no replica or task
    row of its spawn is left."""
    from mlcomp_tpu_torch.db.fencing import FenceLostError
    from mlcomp_tpu_torch.server.ha import LeaderLease
    twin = FleetHaTwin(tmp_path)
    try:
        twin.computer('h1')
        twin.start()
        _create(twin, desired=2)
        twin.port.execute(
            'UPDATE supervisor_lease SET expires_at=? WHERE id=1',
            (_ago(1),))
        rival = LeaderLease(twin.port, holder='rival:2:b',
                            lease_seconds=300)
        assert rival.ensure() is True
        with pytest.raises(FenceLostError):
            twin.port_sup.build()
        st = fleet_state(twin.port)
        assert st['replicas'] == [] and st['replica_tasks'] == []
    finally:
        twin.close()


# ------------------------------------------------- the port's own options
def test_cores_zero_places_with_no_slot(twin):
    """The port's one difference in the rows (server/fleet.py): a fleet
    of ``cores=0`` mints replica tasks of 0 cores, placed with no card
    slot; JAX's ``fleet.cores or 1`` mints 1."""
    twin.computer('h1', cores=1)
    twin.start()
    _create(twin, desired=3, cores=0)
    twin.jax_sup.build()
    twin.port_sup.build()
    theirs, mine = fleet_state(twin.jax), fleet_state(twin.port)
    assert [t['cores'] for t in theirs['replica_tasks']] == [1, 1, 1]
    assert [t['status'] for t in theirs['replica_tasks']] == [
        int(TaskStatus.Queued)] + [int(TaskStatus.NotRan)] * 2
    assert [(t['cores'], t['status'], t['cores_assigned'])
            for t in mine['replica_tasks']] == [
        (0, int(TaskStatus.Queued), '[]')] * 3


def test_activation_lands_in_the_fleet_dag(twin):
    twin.computer('h1')
    twin.start()
    PORT.fleet.create_fleet(twin.port, 'f', 'm', desired=1,
                            activation='argmax')
    with pytest.raises(ValueError, match='activation'):
        PORT.fleet.create_fleet(twin.port, 'g', 'm', activation='relu')
    twin.port_sup.build()
    st = fleet_state(twin.port)
    (dag_id, name, config) = st['dags'][0]
    assert name == 'fleet_f' and st['replica_tasks'][0]['dag'] == dag_id
    assert yaml_load(config)['executors'] == {'serve_replica': {
        'type': 'serve_replica', 'serve': {'activation': 'argmax'}}}


# -------------------------------------------------------- fleets, /metrics
def test_fleets_command_and_replicas_family_match_jax(twin, monkeypatch,
                                                      capsys):
    """``fleets --json`` (and the text form) of both packages over the
    JAX DB after a respawn and a staged swap, and
    ``mlcomp_fleet_replicas`` of both collectors on those rows."""
    from click.testing import CliRunner
    import mlcomp_tpu
    import mlcomp_tpu_torch
    from mlcomp_tpu.__main__ import main as jax_main
    from mlcomp_tpu.db.core import Session as JaxSession
    from mlcomp_tpu.telemetry import export as jax_export_metrics
    from mlcomp_tpu_torch.__main__ import main as port_main
    from mlcomp_tpu_torch.telemetry import export as port_export_metrics
    for host in ('h1', 'h2'):
        twin.computer(host)
    twin.start()
    fid = _create(twin, desired=2)
    twin.tick()
    twin.each(lambda pkg, s: bring_up(pkg, s, fid))
    twin.tick()
    twin.health['http://127.0.0.1:9001'] = False
    for _ in range(2):
        expire_probes(twin)
        twin.tick()
    twin.each(_swap)
    twin.tick()
    rows = []
    for mod, s in ((jax_export_metrics, twin.jax),
                   (port_export_metrics, twin.port)):
        samples = []
        mod._collect_fleet_replicas(s, samples)
        rows.append(samples)
    assert rows[0] == rows[1]
    assert ('', {'fleet': 'f', 'state': 'dead'}, 1) in rows[1]
    cs = f'sqlite:///{twin.tmp_path}/jax.db'
    monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', cs)
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING', cs)
    outs = {}
    for flags in (['--json'], ['--json', '--all'], []):
        JaxSession.cleanup('default')
        Session.cleanup('default')
        try:
            theirs = CliRunner().invoke(jax_main, ['fleets', *flags])
            assert theirs.exit_code == 0, theirs.output
            capsys.readouterr()
            port_main(['fleets', *flags])
            outs[len(flags)] = capsys.readouterr().out
        finally:
            JaxSession.cleanup('default')
            Session.cleanup('default')
        assert outs[len(flags)] == theirs.output
    (item,) = json.loads(outs[1])
    assert (item['target_generation'], item['healthy'],
            len(item['replicas'])) == (2, 1, 5)
    assert 'swapping to generation 2' in outs[0]


# --------------------------------------------------- the replica executor
def _lm_export(folder, scan_layers=True, meta=None):
    spec = {**LM_SPEC, 'scan_layers': scan_layers}
    variables = jax_create_model(**spec).init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))
    return jax_export.export_model(
        str(folder / 'lm'), variables['params'], spec,
        meta={'input_shape': [8], 'input_dtype': 'int32'}
        if meta is None else meta)


@pytest.fixture()
def db(tmp_path):
    session = Session.create_session(
        key=f'fleet-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/port.db')
    migrate(session)
    yield session
    Session.cleanup(session.key)


def _replica_rows(session, model, quantize=None):
    from mlcomp_tpu_torch.db.models import ServeFleet, ServeReplica, Task
    p = PORT.providers
    fleet = ServeFleet(name='exec', model=model, desired=1, created=now())
    p.FleetProvider(session).add(fleet)
    replica = ServeReplica(fleet=fleet.id, generation=1, state='starting',
                           created=now())
    p.ReplicaProvider(session).add(replica)
    task = Task(name='serve_exec', executor='serve_replica',
                status=int(TaskStatus.InProgress), last_activity=_ago(60))
    p.TaskProvider(session).add(task)
    info = {'serve': {'fleet': fleet.id, 'fleet_name': 'exec',
                      'replica': replica.id, 'generation': 1,
                      'model': model, 'batch_size': 4,
                      'quantize': quantize}}
    return replica, task, info


def _executor(session, task, info, **options):
    from mlcomp_tpu_torch.worker.executors import Executor
    ex = Executor.get('serve_replica')(**options)
    ex.additional_info = info
    ex.session = session
    ex.task = task
    ex.beat_interval_s = 0.05
    return ex


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_serve_replica_executor_answers_like_jax(tmp_path, db, quantize):
    """The executor, in a thread as the worker's ``run-task`` runs it,
    on the CPU: endpoint marked after the warm-up, ``http_probe`` true,
    ``/predict`` within the tolerance of JAX's ``ModelServer`` on the
    same export, ``last_activity`` beaten, a drain on shutdown."""
    from mlcomp_tpu.server.serve import ModelServer as JaxServer
    path = _lm_export(tmp_path, scan_layers=quantize is None)
    replica, task, info = _replica_rows(db, path, quantize)
    ex = _executor(db, task, info, serve={'device': 'cpu'})
    result = {}
    thread = threading.Thread(
        target=lambda: result.setdefault('out', ex.work()), daemon=True)
    thread.start()
    rp = PORT.providers.ReplicaProvider(db)
    deadline = time.monotonic() + 60
    while not rp.by_id(replica.id).url and time.monotonic() < deadline:
        time.sleep(0.02)
    row = rp.by_id(replica.id)
    assert row.url == f'http://127.0.0.1:{row.port}' and row.computer
    assert ex.server.primary.predict.quantized == (7 if quantize else 0)
    assert PORT.fleet.http_probe(row.url) is True
    x = np.random.RandomState(3).randint(0, 1024, (3, 8)).astype(np.int32)
    req = urllib.request.Request(
        row.url + '/predict', data=json.dumps({'x': x.tolist()}).encode(),
        headers={'Authorization': TOKEN})
    with urllib.request.urlopen(req, timeout=60) as resp:
        got = np.asarray(json.loads(resp.read())['y'], np.float32)
    jax_server = JaxServer(path, batch_size=4, quantize=quantize, port=0)
    try:
        want = np.asarray(jax_server.primary.handle_predict(
            {'x': x.tolist()})['y'], np.float32)
    finally:
        jax_server.shutdown()
    assert got.shape == want.shape == (3, 8, 1024)
    if quantize:
        assert _row_error(got, want) <= 3e-3
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    before = PORT.providers.TaskProvider(db).by_id(task.id).last_activity
    deadline = time.monotonic() + 30
    while PORT.providers.TaskProvider(db).by_id(task.id).last_activity == \
            before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert PORT.providers.TaskProvider(db).by_id(task.id).last_activity > \
        before
    ex.server.shutdown()
    thread.join(timeout=30)
    assert result['out'] == {'replica': replica.id, 'url': row.url,
                             'requests': 1}


def test_serve_replica_without_input_shape_or_cuda_fails(tmp_path, db):
    path = _lm_export(tmp_path, meta={'input_dtype': 'int32'})
    replica, task, info = _replica_rows(db, path)
    with pytest.raises(ValueError, match='input_shape'):
        _executor(db, task, info, serve={'device': 'cpu'}).work()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            _executor(db, task, info).work()
    row = PORT.providers.ReplicaProvider(db).by_id(replica.id)
    assert row.url is None and row.port is None


# ------------------------------------------------------------ heartbeat
def test_heartbeat_registers_flushes_spans_and_deregisters(tmp_path, db):
    """``start_heartbeat``: the auxiliary row JAX's heartbeat writes (the
    same keys and values but the clock and the port), a traced
    request's ``serve.predict`` span flushed, the row deleted by the
    drain."""
    from mlcomp_tpu.db.core import Session as JaxSession
    from mlcomp_tpu.db.migration import migrate as jax_migrate
    from mlcomp_tpu.server.serve import ModelServer as JaxServer
    from mlcomp_tpu_torch.server.serve import TRACE_HEADER, ModelServer
    path = _lm_export(tmp_path)
    server = ModelServer(path, batch_size=4, port=0, device='cpu')
    server.warmup()
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    key = server.start_heartbeat(db, interval_s=0.05)
    assert key == f'serving:lm:{server.port}'
    trace = 'ab' * 16
    req = urllib.request.Request(
        f'http://127.0.0.1:{server.port}/predict',
        data=json.dumps({'x': np.zeros((1, 8), int).tolist()}).encode(),
        headers={'Authorization': TOKEN, TRACE_HEADER: trace})
    urllib.request.urlopen(req, timeout=60).read()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        spans = db.query('SELECT * FROM telemetry_span WHERE trace_id=?',
                         (trace,))
        row = db.query_one('SELECT data FROM auxiliary WHERE name=?',
                           (key,))
        if spans and row and json.loads(row['data'])['requests'] == 1:
            break
        time.sleep(0.02)
    assert [(s['name'], s['process_role']) for s in spans] == [
        ('serve.predict', 'serving')]
    mine = json.loads(row['data'])
    jax_db = JaxSession.create_session(
        key=f'jax-hb-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/jax.db')
    jax_migrate(jax_db)
    theirs_server = JaxServer(path, batch_size=4, port=0)
    try:
        theirs_server.primary.requests = 1
        jax_key = theirs_server.start_heartbeat(jax_db, interval_s=60)
        deadline = time.monotonic() + 30
        while jax_db.query_one('SELECT 1 FROM auxiliary WHERE name=?',
                               (jax_key,)) is None and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        theirs = json.loads(jax_db.query_one(
            'SELECT data FROM auxiliary WHERE name=?', (jax_key,))['data'])
    finally:
        theirs_server.shutdown()
        JaxSession.cleanup(jax_db.key)
    for d in (mine, theirs):
        for k in ('ts', 'updated', 'port'):
            d.pop(k)
    assert mine == theirs
    assert server.graceful_shutdown(drain_timeout_s=10) is True
    thread.join(timeout=30)
    assert db.query_one('SELECT 1 FROM auxiliary WHERE name=?',
                        (key,)) is None


def test_serve_register_runs(tmp_path, db, monkeypatch, capsys):
    """``serve --register`` heartbeats into the DB: the row exists while
    it serves and is gone after the drain."""
    import mlcomp_tpu_torch.server.__main__ as server_main
    from mlcomp_tpu_torch.server import serve as port_serve
    path = _lm_export(tmp_path)
    seen = {}

    def serve_forever(self):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not seen.get('row'):
            seen['row'] = db.query_one(
                "SELECT name FROM auxiliary WHERE name LIKE 'serving:%'")
            time.sleep(0.02)
        self.graceful_shutdown(drain_timeout_s=5)

    monkeypatch.setattr(port_serve.ModelServer, 'serve_forever',
                        serve_forever)
    monkeypatch.setattr(server_main.signal, 'signal', lambda *a: None)
    monkeypatch.setattr(Session, 'create_session',
                        classmethod(lambda cls, key='default',
                                    connection_string=None: db))
    server_main.main(['serve', path, '--device', 'cpu', '--port', '0',
                      '--register'])
    out = capsys.readouterr().out
    assert 'registered' in out and seen['row']['name'].startswith(
        'serving:lm:')
    assert db.query_one(
        "SELECT 1 FROM auxiliary WHERE name LIKE 'serving:%'") is None

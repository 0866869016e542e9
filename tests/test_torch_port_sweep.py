"""The port's ASHA sweeps against the JAX package's, on the CPU.

- The rung arithmetic (``contrib/search/asha.py``): ``normalize_sweep_spec``
  on valid and invalid specs (same dict, same ``ValueError`` text), the
  rung boundaries, ``promote_cutoff``/``judge``/``score_at_rung`` over
  seeded score lists with ties. Exact equality throughout.
- The scheduler (``server/sweep.py`` in the supervisor tick): one
  scenario on twin sqlite DBs (the rows written through the JAX
  package, the file copied), each package's ``SupervisorBuilder`` ticking
  its own copy, the same ``sweep.score`` reports in the same seeded
  interleaving. After every tick the ``sweep_decision`` rows (task,
  rung, verdict, score, cutoff, cells seen, epoch), the cells' status,
  reason, attempt and placement, the queue messages, the ``sweep`` row
  and the tick's ``sweeps`` trace are equal. Also: the
  ``min_cells_per_rung`` guard, judging without a rung barrier, a raced
  double tick, the watermark, a fenced zombie, a leader killed at the
  ``sweep.prune`` seam, the retry pass, preemption-aware placement.
- The DAG builder, the trainer's rung reports and rung checkpoints,
  ``sweep_probe``, ``/api/sweeps`` and the ``sweeps`` command.
- End to end: JAX's six-cell probe sweep through the port's supervisor
  loop and a threaded pool, and a pruned ``run-task`` process.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import mlcomp_tpu.contrib.search.asha as jax_asha
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.db.models import Computer as JaxComputer
from mlcomp_tpu.db.models import Task as JaxTask
from mlcomp_tpu.db.providers import (
    ComputerProvider as JaxComputers, DockerProvider as JaxDocker,
    SweepDecisionProvider as JaxDecisions, SweepProvider as JaxSweeps,
    TaskProvider as JaxTasks,
)
from mlcomp_tpu.server.create_dags.standard import (
    dag_standard as jax_dag_standard,
)
from mlcomp_tpu.server.supervisor import SupervisorBuilder as JaxSupervisor
from mlcomp_tpu.worker.executors.sweep_probe import (
    probe_score as jax_probe_score,
)
import mlcomp_tpu_torch.contrib.search.asha as asha
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import Task
from mlcomp_tpu_torch.db.providers import (
    QueueProvider, SweepDecisionProvider, SweepProvider, TaskProvider,
)
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.server.supervisor import (
    SupervisorBuilder, SupervisorLoop,
)
from mlcomp_tpu_torch.server.sweep import SWEEP_PRUNED_REASON
from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.utils.misc import hostname, now
from mlcomp_tpu_torch.worker.executors.sweep_probe import (
    SweepProbe, probe_score,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_sweep.py's sweep: six probe cells, rungs at epochs 1, 2, 4
SWEEP_CONFIG = {
    'info': {'name': 'sweep_dag', 'project': 'p_sweep'},
    'executors': {'cells': {
        'type': 'sweep_probe', 'cores': 1, 'cpu': 0, 'memory': 0.001,
        'grid': [{'seed': [0, 1, 2]}, {'lr': [0.05, 0.1]}],
        'sweep': {'metric': 'score', 'mode': 'max', 'eta': 2,
                  'rung_epochs': 1, 'min_cells_per_rung': 2},
        'epochs': 4, 'epoch_s': 0.0,
    }},
}


def _outcome(fn, *args):
    """('ok', value) or (exception type name, message): what a call
    gives, in a form two packages' calls compare by."""
    try:
        return 'ok', fn(*args)
    except Exception as e:          # the comparison is the point
        return type(e).__name__, str(e)


# ---------------------------------------------------------- the arithmetic
#: tests/test_sweep.py's invalid specs, and a few more shapes
BAD_SPECS = [
    {'rung_epochs': 1}, {'metric': 'a'},
    {'metric': 'a', 'rung_epochs': 1, 'rung_steps': 5},
    {'metric': 'a', 'rung_epochs': 1, 'eta': 1},
    {'metric': 'a', 'rung_epochs': 0},
    {'metric': 'a', 'rung_epochs': 1, 'mode': 'best'},
    {'metric': 'a', 'rung_epochs': 1, 'min_cells_per_rung': 1},
    {'metric': 'a', 'rung_epochs': 1, 'typo': 3},
    {'metric': 'a', 'rung_epochs': 1.5}, {'metric': 'a', 'rung_steps': '3'},
    {'metric': 'a', 'rung_epochs': 1, 'eta': 'two'},
    {'metric': 'a', 'rung_epochs': 1, 'eta': None},
    {'metric': 'a', 'rung_epochs': 1, 'min_cells_per_rung': 2.0},
    {'metric': 3, 'rung_epochs': 1}, {'metric': '', 'rung_epochs': 1},
    'not a mapping', None, [],
]


@pytest.mark.parametrize('spec', BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_invalid_specs_raise_jax_text(spec):
    mine = _outcome(asha.normalize_sweep_spec, copy.deepcopy(spec))
    assert mine[0] == 'ValueError'
    assert mine == _outcome(jax_asha.normalize_sweep_spec,
                            copy.deepcopy(spec))


_values = st.one_of(
    st.none(), st.booleans(), st.integers(-3, 40),
    st.floats(-2, 40, allow_nan=False), st.sampled_from(
        ['max', 'min', 'accuracy', 'loss', '', 'x']))


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(
    st.sampled_from(['metric', 'mode', 'eta', 'rung_epochs', 'rung_steps',
                     'min_cells_per_rung', 'other']),
    _values, max_size=6))
def test_normalize_any_spec_like_jax(spec):
    """Any mapping over the spec's keys: the same normalized dict or
    the same ValueError text."""
    mine = _outcome(asha.normalize_sweep_spec, dict(spec))
    assert mine == _outcome(jax_asha.normalize_sweep_spec, dict(spec))


@settings(max_examples=200, deadline=None)
@given(st.sampled_from(['accuracy', 'loss', 'score']),
       st.sampled_from(['max', 'min']),
       st.sampled_from([1.5, 2, 3, 4.0, '3']),
       st.sampled_from(['rung_epochs', 'rung_steps']),
       st.integers(1, 500), st.integers(2, 9))
def test_normalize_valid_specs_like_jax(metric, mode, eta, unit, base,
                                        min_cells):
    spec = {'metric': metric, 'mode': mode, 'eta': eta, unit: base,
            'min_cells_per_rung': min_cells}
    mine = asha.normalize_sweep_spec(dict(spec))
    assert mine == jax_asha.normalize_sweep_spec(dict(spec))
    assert mine['base'] == base and mine['unit'] == unit[5:]


@pytest.mark.parametrize('eta', [1.5, 2, 3])
@pytest.mark.parametrize('base', [1, 2, 3, 4, 5])
def test_rung_boundaries_like_jax_and_strictly_monotone(base, eta):
    bounds = [asha.rung_boundary(base, eta, r) for r in range(30)]
    assert bounds == [jax_asha.rung_boundary(base, eta, r)
                      for r in range(30)]
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    for budget in range(0, 400, 7):
        assert asha.rung_boundaries(base, eta, budget) == \
            jax_asha.rung_boundaries(base, eta, budget)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.sampled_from([1.5, 2, 3]),
       st.sampled_from(['max', 'min']), st.integers(1, 24))
def test_cutoff_judge_and_score_at_rung_like_jax(seed, eta, mode, n):
    """Seeded score lists on a coarse grid (ties at the cutoff are the
    common case), every member judged; rung reads over seeded report
    ladders."""
    rng = np.random.default_rng(seed)
    scores = [float(v) for v in rng.integers(0, 5, n) / 4.0]
    cutoff = asha.promote_cutoff(scores, eta, mode)
    assert cutoff == jax_asha.promote_cutoff(scores, eta, mode)
    for s in scores:
        assert asha.judge(s, scores, eta, mode) == \
            jax_asha.judge(s, scores, eta, mode)
    budgets = np.cumsum(rng.integers(1, 4, n))
    reports = [(int(b), s) for b, s in zip(budgets, scores)]
    for boundary in range(0, int(budgets[-1]) + 3):
        assert asha.score_at_rung(reports, boundary) == \
            jax_asha.score_at_rung(reports, boundary)
    assert _outcome(asha.promote_cutoff, [], eta, mode) == \
        _outcome(jax_asha.promote_cutoff, [], eta, mode)


# --------------------------------------------------------------- the twin
class SweepTwin:
    """A sweep's rows written through the JAX package, the DB copied,
    and each package's supervisor ticking its own copy."""

    def __init__(self, tmp_path, config=None, computers=(('host1', 2),),
                 ghosts=()):
        self.tmp_path = tmp_path
        self.key = f'sweep-twin-{tmp_path}'
        self.jax_cs = f'sqlite:///{tmp_path}/jax.db'
        self.port_cs = f'sqlite:///{tmp_path}/port.db'
        jax = JaxSession.create_session(key=self.key,
                                        connection_string=self.jax_cs)
        jax_migrate(jax)
        for name, cores in computers:
            JaxComputers(jax).create_or_update(JaxComputer(
                name=name, cores=cores, cpu=16, memory=64, ip='127.0.0.1',
                can_process_tasks=True), 'name')
            JaxDocker(jax).heartbeat(name, 'default')
        for computer, reason in ghosts:
            JaxTasks(jax).add(JaxTask(
                name='ghost', executor='noop_exec',
                status=int(TaskStatus.Stopped), computer_assigned=computer,
                failure_reason=reason, last_activity=now()))
        dag, tasks = jax_dag_standard(jax,
                                      copy.deepcopy(config or SWEEP_CONFIG))
        self.dag = dag.id
        self.cells = tasks['cells']
        self.sweep = JaxSweeps(jax).by_dag(dag.id)[0].id
        JaxSession.cleanup(self.key)           # checkpoints the WAL
        shutil.copy(tmp_path / 'jax.db', tmp_path / 'port.db')
        self.jax = JaxSession.create_session(key=self.key,
                                             connection_string=self.jax_cs)
        self.port = Session.create_session(key=self.key,
                                           connection_string=self.port_cs)
        self.jax_sup = JaxSupervisor(session=self.jax)
        self.port_sup = SupervisorBuilder(session=self.port)

    def both(self, sql, params=()):
        self.jax.execute(sql, params)
        self.port.execute(sql, params)

    def set_status(self, cell, status):
        self.both('UPDATE task SET status=? WHERE id=?',
                  (int(status), cell))

    def report(self, cell, budget, value, score=None):
        """One rung report through each package's ``report_sweep_score``,
        and the cell's best-so-far score as the trainer keeps it."""
        assert jax_asha.report_sweep_score(self.jax, cell, budget, value)
        assert asha.report_sweep_score(self.port, cell, budget, value)
        if score is not None:
            self.both('UPDATE task SET score=? WHERE id=?', (score, cell))

    def statuses(self) -> dict:
        return {r['id']: r['status'] for r in self.port.query(
            'SELECT id, status FROM task WHERE id IN (%s)'
            % ','.join(map(str, self.cells)))}

    def tick(self, jax_sup=None, port_sup=None):
        (jax_sup or self.jax_sup).build()
        (port_sup or self.port_sup).build()
        return self.compare()

    def compare(self) -> dict:
        theirs, mine = sweep_state(self.jax, self.sweep), \
            sweep_state(self.port, self.sweep)
        assert mine == theirs
        return mine

    def close(self):
        JaxSession.cleanup(self.key)
        Session.cleanup(self.key)


def sweep_state(session, sweep_id) -> dict:
    decisions = [tuple(r) for r in session.query(
        'SELECT task, rung, verdict, score, cutoff, cells_seen, epoch '
        'FROM sweep_decision WHERE sweep=? ORDER BY id', (sweep_id,))]
    tasks = [tuple(r) for r in session.query(
        'SELECT id, status, failure_reason, attempt, next_retry_at, '
        'computer_assigned, cores_assigned, score FROM task ORDER BY id')]
    messages = []
    for r in session.query('SELECT * FROM queue_message ORDER BY id'):
        payload = json.loads(r['payload'])
        payload.pop('trace_id', None)
        messages.append((r['queue'], r['status'], payload))
    sweep = tuple(session.query_one(
        'SELECT status, best_task, best_score, cells FROM sweep WHERE id=?',
        (sweep_id,)))
    row = session.query_one(
        "SELECT data FROM auxiliary WHERE name='supervisor'")
    aux = json.loads(row['data']) if row else {}
    return {'decisions': decisions, 'tasks': tasks, 'messages': messages,
            'sweep': sweep, 'aux': aux.get('sweeps')}


@pytest.fixture()
def twin(tmp_path):
    t = SweepTwin(tmp_path)
    yield t
    t.close()


def _pruned(st_) -> set:
    return {t[0] for t in st_['tasks'] if t[2] == SWEEP_PRUNED_REASON}


# ------------------------------------------------------------ the scheduler
@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_a_seeded_sweep_gets_jax_verdicts_tick_by_tick(tmp_path, seed):
    """Cells start, report at random budgets in a seeded order (scores
    on a coarse grid, so ties at the cutoff occur), finish at epoch 4;
    both ticks agree at every step until the sweep is done, with at
    least one prune and every freed slot re-placed."""
    twin = SweepTwin(tmp_path)
    try:
        rng = np.random.default_rng(seed)
        budget = {c: 0 for c in twin.cells}
        best = {}
        st_ = twin.tick()
        for _ in range(60):
            if st_['sweep'][0] == 'done':
                break
            status = twin.statuses()
            for cell in twin.cells:
                if status[cell] == int(TaskStatus.Queued):
                    twin.set_status(cell, TaskStatus.InProgress)
            running = [c for c in twin.cells if status[c] in (
                int(TaskStatus.Queued), int(TaskStatus.InProgress))]
            for cell in rng.permutation(running):
                cell = int(cell)
                if rng.random() < 0.3:
                    continue
                budget[cell] += 1
                value = float(rng.integers(0, 6)) / 5.0
                best[cell] = max(best.get(cell, value), value)
                twin.report(cell, budget[cell], value, score=best[cell])
                if budget[cell] >= 4:
                    twin.set_status(cell, TaskStatus.Success)
            st_ = twin.tick()
        assert st_['sweep'][0] == 'done'
        pruned = _pruned(st_)
        assert pruned and len(st_['decisions']) >= len(twin.cells)
        prune_rows = [d for d in st_['decisions'] if d[2] == 'prune']
        assert sorted(d[0] for d in prune_rows) == sorted(pruned)
        assert all(d[3] < d[4] for d in prune_rows)      # below cutoff
        assert all(t[3] in (0, None) for t in st_['tasks']
                   if t[0] in pruned)
    finally:
        twin.close()


def _front_two(twin):
    """Tick once (two cores: two cells Queued), start them."""
    twin.tick()
    status = twin.statuses()
    running = [c for c in twin.cells if status[c] == int(TaskStatus.Queued)]
    assert len(running) == 2
    for cell in running:
        twin.set_status(cell, TaskStatus.InProgress)
    return running


def test_a_prune_recycles_its_slot_in_the_same_tick(twin):
    running = _front_two(twin)
    for cell, value in zip(running, (0.9, 0.2)):
        twin.report(cell, 1, value)
    st_ = twin.tick()
    assert _pruned(st_) == {running[1]}
    queued = [t for t in st_['tasks'] if t[1] == int(TaskStatus.Queued)]
    assert len(queued) == 1
    assert [(m[1], m[2]['task_id']) for m in st_['messages']
            if m[2]['task_id'] == running[1]] == [('revoked', running[1])]
    assert st_['aux'] == {str(twin.sweep): {
        'promoted': [{'task': running[0], 'rung': 0, 'score': 0.9,
                      'cutoff': 0.9, 'of': 2}],
        'pruned': [{'task': running[1], 'rung': 0, 'score': 0.2,
                    'cutoff': 0.9, 'of': 2}],
        'cells': 6}}


def test_the_min_cells_per_rung_guard(tmp_path):
    twin = SweepTwin(tmp_path, computers=(('host1', 1),))
    try:
        twin.tick()
        first = next(c for c, s in twin.statuses().items()
                     if s == int(TaskStatus.Queued))
        twin.set_status(first, TaskStatus.InProgress)
        twin.report(first, 1, 0.01)
        st_ = twin.tick()
        assert st_['decisions'] == [] and not _pruned(st_)
    finally:
        twin.close()


def test_judging_has_no_rung_barrier(tmp_path):
    twin = SweepTwin(tmp_path, computers=(('host1', 6),))
    try:
        cells = twin.cells
        for cell in cells[:4]:
            twin.set_status(cell, TaskStatus.InProgress)
        for cell, s0 in zip(cells[:4], (0.8, 0.7, 0.3, 0.2)):
            twin.report(cell, 1, s0)
        twin.report(cells[0], 2, 0.9)
        twin.report(cells[1], 2, 0.85)
        st_ = twin.tick()
        verdicts = {(d[0], d[1]): d[2] for d in st_['decisions']}
        assert verdicts[(cells[0], 1)] == 'promote'
        assert verdicts[(cells[1], 1)] == 'prune'
        assert {cells[1], cells[2], cells[3]} == _pruned(st_)
    finally:
        twin.close()


def test_a_raced_double_tick_records_once(twin):
    running = _front_two(twin)
    for cell, value in zip(running, (0.9, 0.2)):
        twin.report(cell, 1, value)
    jax2, port2 = JaxSupervisor(session=twin.jax), \
        SupervisorBuilder(session=twin.port)
    twin.tick()
    st_ = twin.tick(jax2, port2)
    assert len({d[:2] for d in st_['decisions']}) == \
        len(st_['decisions']) == 2
    assert not SweepDecisionProvider(twin.port).record(
        twin.sweep, running[1], 0, 'prune', 0.2, 0.9, 2, 0)
    assert not JaxDecisions(twin.jax).record(
        twin.sweep, running[1], 0, 'prune', 0.2, 0.9, 2, 0)
    twin.compare()


def test_the_watermark_skips_idle_ticks_and_a_crash_rejudges(
        twin, monkeypatch):
    """Reports only append: a tick that sees no new ``sweep.score`` id
    reads no reports. A crashed sweep tick leaves the watermark unset,
    so the next tick judges again."""
    import mlcomp_tpu.db.providers.sweep as jax_sweep_providers
    import mlcomp_tpu_torch.db.providers.sweep as port_sweep_providers
    calls = {'jax': 0, 'port': 0}
    for name, module in (('jax', jax_sweep_providers),
                         ('port', port_sweep_providers)):
        original = module.SweepProvider.rung_reports

        def counted(self, ids, _name=name, _original=original):
            calls[_name] += 1
            return _original(self, ids)

        monkeypatch.setattr(module.SweepProvider, 'rung_reports', counted)
    cell = twin.cells[0]
    twin.set_status(cell, TaskStatus.InProgress)
    twin.report(cell, 1, 0.5)
    for _ in range(3):
        twin.tick()
    assert calls == {'jax': 1, 'port': 1}
    twin.report(cell, 2, 0.6)
    twin.tick()
    assert calls == {'jax': 2, 'port': 2}
    # one crashed sweep tick (a transient DB error) in each package
    for sup in (twin.jax_sup, twin.port_sup):
        real = sup.sweep_scheduler._tick_sweep

        def crash_once(sweep, judge=True, _real=real, _sup=sup):
            _sup.sweep_scheduler._tick_sweep = _real
            raise RuntimeError('transient')

        sup.sweep_scheduler._tick_sweep = crash_once
    twin.report(cell, 3, 0.7)
    twin.tick()                     # crashed: watermark left unset
    assert calls == {'jax': 2, 'port': 2}
    twin.tick()                     # no new report, judged all the same
    assert calls == {'jax': 3, 'port': 3}
    twin.tick()
    assert calls == {'jax': 3, 'port': 3}


def test_a_zombie_leaders_prune_is_fenced_off(twin):
    from mlcomp_tpu.db.fencing import FenceLostError as JaxFenceLost
    from mlcomp_tpu.server.ha import StaticLease as JaxStatic
    from mlcomp_tpu_torch.db.fencing import FenceLostError
    from mlcomp_tpu_torch.server.ha import StaticLease
    twin.both('UPDATE supervisor_lease SET epoch=5, holder=? WHERE id=1',
              ('live:leader:xyz',))
    cells = twin.cells[:2]
    for cell, value in zip(cells, (0.9, 0.2)):
        twin.set_status(cell, TaskStatus.InProgress)
        twin.report(cell, 1, value)
    with pytest.raises(JaxFenceLost):
        JaxSupervisor(session=twin.jax,
                      lease=JaxStatic(3)).sweep_scheduler.tick()
    with pytest.raises(FenceLostError):
        SupervisorBuilder(session=twin.port,
                          lease=StaticLease(3)).sweep_scheduler.tick()
    st_ = twin.compare()
    assert st_['decisions'] == [] and not _pruned(st_)
    # a fenced live leader at the store's epoch judges and stamps it
    twin.jax_sup = JaxSupervisor(session=twin.jax, lease=JaxStatic(5))
    twin.port_sup = SupervisorBuilder(session=twin.port,
                                      lease=StaticLease(5))
    st_ = twin.tick()
    assert _pruned(st_) == {cells[1]}
    assert {d[6] for d in st_['decisions']} == {5}


_KILLED_TICK = '''
import sys
{imports}
s = Session.create_session(key='killed', connection_string=sys.argv[1])
SupervisorBuilder(session=s).build()
'''


def _killed_tick(tmp_path, package: str, cs: str):
    """One tick of ``package``'s supervisor in a process of its own,
    killed (``os._exit(137)``) at the ``sweep.prune`` seam."""
    script = _KILLED_TICK.format(imports=(
        f'from {package}.db.core import Session\n'
        f'from {package}.server.supervisor import SupervisorBuilder'))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu',
               MLCOMP_FAULTS=json.dumps(
                   {'sweep.prune': {'action': 'exit', 'code': 137}}))
    proc = subprocess.run([sys.executable, '-c', script, cs], env=env,
                          cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 137, proc.stderr[-2000:]


def test_a_leader_killed_at_the_prune_seam_is_repaired_once(twin,
                                                             tmp_path):
    """The verdict is recorded, the process dies before applying it; a
    standby's first tick finishes the prune, and no tick records it
    again."""
    running = _front_two(twin)
    for cell, value in zip(running, (0.9, 0.2)):
        twin.report(cell, 1, value)
    JaxSession.cleanup(twin.key)
    Session.cleanup(twin.key)
    _killed_tick(tmp_path, 'mlcomp_tpu', twin.jax_cs)
    _killed_tick(tmp_path, 'mlcomp_tpu_torch', twin.port_cs)
    twin.jax = JaxSession.create_session(key=twin.key,
                                         connection_string=twin.jax_cs)
    twin.port = Session.create_session(key=twin.key,
                                       connection_string=twin.port_cs)
    st_ = twin.compare()
    assert [d[2] for d in st_['decisions']] == ['promote', 'prune']
    assert not _pruned(st_) and twin.statuses()[running[1]] == \
        int(TaskStatus.InProgress)
    twin.jax_sup = JaxSupervisor(session=twin.jax)
    twin.port_sup = SupervisorBuilder(session=twin.port)
    st_ = twin.tick()
    assert _pruned(st_) == {running[1]}
    assert st_['aux'][str(twin.sweep)]['repaired'] == [running[1]]
    for _ in range(2):
        st_ = twin.tick()
    assert [d[2] for d in st_['decisions']] == ['promote', 'prune']


def test_the_retry_pass_never_loads_a_pruned_cell(twin, monkeypatch):
    from mlcomp_tpu_torch.recovery import TRANSIENT_REASONS, is_transient
    assert SWEEP_PRUNED_REASON not in TRANSIENT_REASONS
    assert not is_transient(SWEEP_PRUNED_REASON)
    running = _front_two(twin)
    for cell, value in zip(running, (0.9, 0.2)):
        twin.report(cell, 1, value)
    twin.tick()
    loaded = []
    session = twin.port_sup.session
    query = session.query

    def spy(sql, params=(), *a, **k):
        rows = query(sql, params, *a, **k)
        if sql.startswith('SELECT * FROM task WHERE status=? AND '
                          'parent IS NULL'):
            loaded.extend(r['id'] for r in rows)
        return rows

    monkeypatch.setattr(session, 'query', spy)
    for _ in range(3):
        st_ = twin.tick()
    row = next(t for t in st_['tasks'] if t[0] == running[1])
    assert row[1:5] == (int(TaskStatus.Failed), SWEEP_PRUNED_REASON, 0,
                        None)
    assert running[1] not in loaded
    assert twin.port.query('SELECT * FROM alert WHERE task=?',
                           (running[1],)) == []


def test_a_distributed_cells_prune_gang_aborts_only_it(twin):
    cells = twin.cells[:2]
    for cell, value in zip(cells, (0.9, 0.2)):
        twin.both('UPDATE task SET gang_id=? WHERE id=?', (f'g{cell}', cell))
        twin.set_status(cell, TaskStatus.InProgress)
        twin.report(cell, 1, value)
    aborted = {'jax': [], 'port': []}
    twin.jax_sup.sweep_scheduler.gang_abort = aborted['jax'].append
    twin.port_sup.sweep_scheduler.gang_abort = aborted['port'].append
    twin.jax_sup.sweep_scheduler.tick()
    twin.port_sup.sweep_scheduler.tick()
    assert aborted == {'jax': [cells[1]], 'port': [cells[1]]}


def test_the_sweep_finishes_with_its_best_finisher(twin):
    for i, cell in enumerate(twin.cells[:-1]):
        twin.both('UPDATE task SET score=?, status=? WHERE id=?',
                  (0.1 * (i + 1), int(TaskStatus.Success), cell))
    spike = twin.cells[-1]
    twin.both('UPDATE task SET score=0.99, status=?, failure_reason=? '
              'WHERE id=?', (int(TaskStatus.Failed), SWEEP_PRUNED_REASON,
                             spike))
    st_ = twin.tick()
    assert st_['sweep'][:2] == ('done', twin.cells[-2])
    assert st_['sweep'][2] == pytest.approx(0.5)
    assert st_['aux'][str(twin.sweep)]['done'] is True


def test_sweep_cells_steer_off_retry_prone_hosts(tmp_path):
    """tests/test_sweep.py's placement scenario: 'flaky' has two
    transient verdicts on record; the cells fill 'calm' first although
    packing alone would prefer the bigger host."""
    twin = SweepTwin(tmp_path, computers=(('flaky', 8), ('calm', 4)),
                     ghosts=(('flaky', 'preempted'),
                             ('flaky', 'worker-lost')))
    try:
        st_ = twin.tick()
        placed = [t[5] for t in st_['tasks'] if t[0] in twin.cells]
        assert placed[:4] == ['calm'] * 4 and placed[4:] == ['flaky'] * 2
        assert twin.port_sup._retry_prone_counts() == \
            twin.jax_sup._retry_prone_counts() == {'flaky': 2}
    finally:
        twin.close()


# -------------------------------------------------------------- the builder
@pytest.fixture()
def sessions(tmp_path):
    jax_s = JaxSession.create_session(
        key=f'sweep-dag-jax-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/jax_dag.db')
    port_s = Session.create_session(
        key=f'sweep-dag-port-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/port_dag.db')
    jax_migrate(jax_s)
    migrate(port_s)
    yield jax_s, port_s
    JaxSession.cleanup(jax_s.key)
    Session.cleanup(port_s.key)


def _trainer_config(type_='jax_train', **over):
    spec = {'type': type_, 'cores': 1, 'grid': [{'lr': [0.1, 0.2]}],
            'main_metric': 'loss', 'minimize': True,
            'sweep': {'metric': 'loss', 'mode': 'min', 'rung_epochs': 1}}
    spec.update(over)
    return {'info': {'name': 'mm', 'project': 'p_mm'},
            'executors': {'train': spec}}


def _via_params(bad=False):
    config = _trainer_config()
    ex = config['executors']['train']
    ex['params'] = {'main_metric': ex.pop('main_metric'),
                    'minimize': ex.pop('minimize')}
    if bad:
        ex['sweep']['mode'] = 'max'
    return config


def _no_grid():
    config = copy.deepcopy(SWEEP_CONFIG)
    del config['executors']['cells']['grid']
    return config


def _bad_eta():
    config = copy.deepcopy(SWEEP_CONFIG)
    config['executors']['cells']['sweep']['eta'] = 0.5
    return config


BUILDER_CONFIGS = {
    'probe_grid': lambda: copy.deepcopy(SWEEP_CONFIG),
    'trainer': _trainer_config,
    'train_type': lambda: _trainer_config('train'),
    'steps_unit': lambda: _trainer_config(sweep={
        'metric': 'loss', 'mode': 'min', 'rung_steps': 50, 'eta': 3,
        'min_cells_per_rung': 3}),
    'via_params': _via_params,
    'no_grid': _no_grid,
    'bad_eta': _bad_eta,
    'wrong_metric': lambda: _trainer_config(sweep={
        'metric': 'accuracy', 'mode': 'min', 'rung_epochs': 1}),
    'wrong_mode': lambda: _trainer_config(sweep={
        'metric': 'loss', 'mode': 'max', 'rung_epochs': 1}),
    'wrong_mode_via_params': lambda: _via_params(bad=True),
    'unknown_key': lambda: _trainer_config(sweep={
        'metric': 'loss', 'mode': 'min', 'rung_epochs': 1, 'rungs': 3}),
}


def _builder_rows(session, dag_id):
    sweeps = [{k: v for k, v in dict(r).items()
               if k not in ('created', 'updated')}
              for r in session.query('SELECT * FROM sweep ORDER BY id')]
    cells = [(r['name'], (yaml_load(r['additional_info']) or {}).get(
        'sweep'), r['type']) for r in session.query(
        'SELECT * FROM task WHERE dag=? ORDER BY id', (dag_id,))]
    return sweeps, cells


@pytest.mark.parametrize('name', sorted(BUILDER_CONFIGS))
def test_the_builder_writes_jax_rows_and_refusals(sessions, name):
    from tests.test_torch_port_dag import dag_rows
    jax_s, port_s = sessions
    theirs = _outcome(jax_dag_standard, jax_s, BUILDER_CONFIGS[name]())
    mine = _outcome(dag_standard, port_s, BUILDER_CONFIGS[name]())
    if theirs[0] != 'ok':
        assert mine == theirs
        assert theirs[0] == 'ValueError'
    else:
        assert mine[0] == 'ok'
        (jax_dag, _), (port_dag, _) = theirs[1], mine[1]
        assert _builder_rows(port_s, port_dag.id) == \
            _builder_rows(jax_s, jax_dag.id)
        assert dag_rows(port_s, port_dag.id) == dag_rows(jax_s, jax_dag.id)
        sweeps, cells = _builder_rows(port_s, port_dag.id)
        assert len(sweeps) == 1 and all(
            c[1] == {**asha.normalize_sweep_spec(
                BUILDER_CONFIGS[name]()['executors'][
                    'cells' if name == 'probe_grid' else 'train']['sweep']),
                'id': sweeps[0]['id']} for c in cells)
    for table in ('dag', 'task', 'sweep'):
        count = f'SELECT COUNT(*) AS c FROM {table}'
        assert port_s.query_one(count)['c'] == jax_s.query_one(count)['c']


# -------------------------------------------------------------- the trainer
def _trainers(tmp_path):
    """JAX's trainer and the port's, each with a session on its own DB
    and a cell task row of the same id (and a parent for the rank)."""
    from mlcomp_tpu.train.executor import JaxTrain
    from mlcomp_tpu_torch.train.executor import Train
    out = []
    for name, session_cls, do_migrate, task_cls, provider_cls, trainer in (
            ('jax', JaxSession, jax_migrate, JaxTask, JaxTasks,
             lambda: JaxTrain(model={'name': 'mlp'}, epochs=1)),
            ('port', Session, migrate, Task, TaskProvider,
             lambda: Train(model={'name': 'mlp'}, epochs=1,
                           device='cpu'))):
        session = session_cls.create_session(
            key=f'trainer-{name}-{tmp_path}',
            connection_string=f'sqlite:///{tmp_path}/{name}_tr.db')
        do_migrate(session)
        cell = task_cls(name='cell', executor='cells',
                        status=int(TaskStatus.InProgress),
                        last_activity=now())
        provider_cls(session).add(cell)
        rank = task_cls(name='rank', executor='cells', parent=cell.id,
                        status=int(TaskStatus.InProgress),
                        last_activity=now())
        provider_cls(session).add(rank)
        ex = trainer()
        ex.session = session
        out.append((session, ex, cell, rank))
    return out


@pytest.mark.parametrize('unit, base, eta, per_epoch', [
    ('epochs', 1, 2.0, 10), ('epochs', 2, 1.5, 10), ('epochs', 1, 3.0, 7),
    ('steps', 20, 2.0, 10), ('steps', 15, 2.0, 10), ('steps', 7, 1.5, 4),
    ('steps', 100, 3.0, 64)])
def test_rung_reports_and_rung_flags_like_jax(tmp_path, unit, base, eta,
                                              per_epoch):
    """Both trainers' ``_report_sweep`` over twelve epochs (step-unit
    boundaries mid-epoch among them, a rank reporting to its cell, a
    missing score): the same (budget, value) rows and rung flags."""
    both = _trainers(tmp_path)
    spec = {'id': 1, 'metric': 'accuracy', 'mode': 'max', 'eta': eta,
            'base': base, 'unit': unit, 'min_cells_per_rung': 2}
    flags, rows = [], []
    try:
        for session, ex, cell, rank in both:
            ex.additional_info = {'sweep': dict(spec)}
            mine = []
            for epoch in range(12):
                ex.task = rank if epoch % 5 == 4 else cell
                score = None if epoch == 6 else 0.05 * (epoch + 1)
                mine.append(ex._report_sweep(epoch, per_epoch, score))
            flags.append(mine)
            rows.append([tuple(r) for r in session.query(
                'SELECT task, step, value, kind, component, tags FROM '
                'metric WHERE name=? ORDER BY id',
                (asha.SWEEP_SCORE_METRIC,))])
        assert flags[0] == flags[1] and rows[0] == rows[1]
        assert len(rows[1]) == 11 and any(flags[1])
        assert {r[0] for r in rows[1]} == {both[1][2].id}
    finally:
        JaxSession.cleanup(both[0][0].key)
        Session.cleanup(both[1][0].key)


def _mlp_cells(epochs=3, **extra):
    return {'info': {'name': 'sweep_train', 'project': 'p_st'},
            'executors': {'train': {
                'type': 'train', 'device': 'cpu',
                'model': {'name': 'mlp', 'num_classes': 4, 'hidden': [16],
                          'dtype': 'float32'},
                'dataset': {'name': 'synthetic_images', 'n_train': 128,
                            'n_valid': 32, 'image_size': 8, 'channels': 1,
                            'num_classes': 4},
                'batch_size': 32, 'checkpoint_every': 4,
                'async_checkpoint': False, 'telemetry': False,
                'grid': [{'stages': [
                    [{'name': 's1', 'epochs': epochs,
                      'optimizer': {'name': 'adamw', 'lr': lr}}]
                    for lr in (1e-3, 1.0)]}],
                'sweep': {'metric': 'accuracy', 'mode': 'max', 'eta': 2,
                          'rung_epochs': 1}, **extra}}}


@pytest.fixture()
def train_db(tmp_path, monkeypatch):
    import mlcomp_tpu_torch
    monkeypatch.setattr(mlcomp_tpu_torch, 'TASK_FOLDER',
                        str(tmp_path / 'tasks'))
    session = Session.create_session(
        key=f'sweep-train-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/train.db')
    migrate(session)
    folder = tmp_path / 'exp'
    folder.mkdir()
    monkeypatch.chdir(folder)
    yield session, folder
    Session.cleanup(session.key)


def test_a_sweep_cell_reports_each_epoch_and_saves_at_its_rungs(
        train_db, monkeypatch):
    """The trainer end to end on the CPU: a ``sweep.score`` row an
    epoch, and a checkpoint at the rungs (epochs 1 and 2) that
    ``checkpoint_every: 4`` alone skips."""
    import mlcomp_tpu_torch.train.executor as train_executor
    from mlcomp_tpu_torch.worker.tasks import execute_by_id
    session, folder = train_db
    saved = []
    real_save = train_executor.save_checkpoint

    def spy(directory, state, meta, best=False):
        saved.append(meta['epoch'])
        return real_save(directory, state, meta, best=best)

    monkeypatch.setattr(train_executor, 'save_checkpoint', spy)
    _, tasks = dag_standard(session, _mlp_cells(),
                            upload_folder=str(folder))
    cell = tasks['train'][0]
    assert execute_by_id(cell, folder=str(folder),
                         session=session) == 'success'
    rows = session.query('SELECT task, step, value FROM metric WHERE '
                         'name=? ORDER BY id', (asha.SWEEP_SCORE_METRIC,))
    assert [(r['task'], r['step']) for r in rows] == [
        (cell, 1), (cell, 2), (cell, 3)]
    assert all(0.0 <= r['value'] <= 1.0 for r in rows)
    assert {0, 1} <= set(saved) and saved == sorted(saved)
    logged = [r['message'] for r in session.query(
        'SELECT message FROM log WHERE task=? ORDER BY id', (cell,))]
    assert [m for m in logged if m.startswith('sweep rung checkpoint')] \
        == ['sweep rung checkpoint at epoch 0',
            'sweep rung checkpoint at epoch 1']


def test_the_launch_rows_count_the_completed_steps(train_db, monkeypatch):
    """``train.kernel_launches.<kernel>`` and ``train.steps`` (rows of
    the port's trainer): none on the CPU, where nothing launches; with
    launches (20 norm forwards a step here, counted as the card counts
    them), the launches of the steps completed and those steps."""
    import mlcomp_tpu_torch.train.executor as train_executor
    from mlcomp_tpu_torch.worker.tasks import execute_by_id
    session, folder = train_db
    _, tasks = dag_standard(session, _mlp_cells(epochs=2),
                            upload_folder=str(folder))
    first, second = tasks['train']
    assert execute_by_id(first, folder=str(folder),
                         session=session) == 'success'
    query = ("SELECT name, step, value FROM metric WHERE task=? AND "
             "(name LIKE 'train.kernel_launches.%' OR name='train.steps')")
    assert session.query(query, (first,)) == []
    calls = []

    def counted_launches():
        calls.append(1)
        return {'fused_norm': 20 * (len(calls) - 1) + 7,
                'flash_attention_fwd': 3}

    monkeypatch.setattr(train_executor, 'kernel_launches',
                        counted_launches)
    assert execute_by_id(second, folder=str(folder),
                         session=session) == 'success'
    steps = 2 * (128 // 32)
    assert sorted(tuple(r) for r in session.query(query, (second,))) == [
        ('train.kernel_launches.fused_norm', steps, 20.0 * steps),
        ('train.steps', steps, float(steps))]


def test_an_in_process_cell_stops_after_its_prune(train_db, monkeypatch):
    """No signal reaches a trainer that runs in the worker's process:
    it reads its row at the epoch boundary and stops, the verdict kept."""
    from mlcomp_tpu_torch.train.executor import Train
    from mlcomp_tpu_torch.worker.tasks import execute_by_id
    session, folder = train_db
    _, tasks = dag_standard(session, _mlp_cells(epochs=4),
                            upload_folder=str(folder))
    cell = tasks['train'][1]
    real = Train._report_sweep

    def pruned_after_first(self, global_epoch, steps, score):
        out = real(self, global_epoch, steps, score)
        if global_epoch == 0:
            provider = TaskProvider(session)
            provider.fail_with_reason(provider.by_id(cell),
                                      SWEEP_PRUNED_REASON)
        return out

    monkeypatch.setattr(Train, '_report_sweep', pruned_after_first)
    assert execute_by_id(cell, folder=str(folder),
                         session=session) == 'failed'
    row = TaskProvider(session).by_id(cell)
    assert (row.status, row.failure_reason) == (int(TaskStatus.Failed),
                                                SWEEP_PRUNED_REASON)
    assert json.loads(row.result) == {
        'pruned_at_epoch': 0, 'best_score': pytest.approx(row.score)}
    assert session.query_one(
        'SELECT COUNT(*) AS c FROM metric WHERE name=? AND task=?',
        (asha.SWEEP_SCORE_METRIC, cell))['c'] == 1


# -------------------------------------------------------------- sweep_probe
def test_probe_scores_equal_jax():
    for lr in (1e-4, 0.01, 0.05, 0.1, 0.3, 1.0, 0.0):
        for seed in range(12):
            for epoch in range(0, 14):
                assert probe_score(lr, seed, epoch) == \
                    jax_probe_score(lr, seed, epoch)


def test_a_probe_stops_at_the_next_poll_after_a_prune(tmp_path):
    session = Session.create_session(
        key=f'probe-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/probe.db')
    try:
        migrate(session)
        task = Task(name='cell', executor='cells',
                    status=int(TaskStatus.InProgress), last_activity=now())
        TaskProvider(session).add(task)
        probe = SweepProbe(lr=0.1, seed=1, epochs=3, epoch_s=0.4)
        probe.session, probe.task = session, task
        out = {}
        thread = threading.Thread(target=lambda: out.update(
            result=probe.work()))
        t0 = time.monotonic()
        thread.start()
        time.sleep(0.6)                 # mid epoch 2
        TaskProvider(session).fail_with_reason(
            TaskProvider(session).by_id(task.id), SWEEP_PRUNED_REASON)
        t_prune = time.monotonic()
        thread.join(timeout=10)
        assert out['result'] == {'pruned_at': 1,
                                 'score': probe_score(0.1, 1, 1)}
        assert time.monotonic() - t_prune <= SweepProbe.POLL_S + 0.2
        assert time.monotonic() - t0 < 1.2
        rows = session.query('SELECT step FROM metric WHERE name=?',
                             (asha.SWEEP_SCORE_METRIC,))
        assert [r['step'] for r in rows] == [1]
    finally:
        Session.cleanup(session.key)


# ------------------------------------------------------ routes and command
def _without_time(obj):
    if isinstance(obj, dict):
        return {k: _without_time(v) for k, v in obj.items() if k != 'time'}
    if isinstance(obj, list):
        return [_without_time(v) for v in obj]
    return obj


def test_api_sweeps_and_the_command_match_jax(tmp_path, monkeypatch,
                                               capsys):
    """Two sweeps on the twin DBs, one done: ``api_sweeps`` with ``all``
    false and true (time strings aside) and ``sweeps`` (``--json``,
    ``--all``, text) of both packages."""
    from click.testing import CliRunner
    import mlcomp_tpu
    import mlcomp_tpu_torch
    from mlcomp_tpu.__main__ import main as jax_main
    from mlcomp_tpu.server.api import api_sweeps as jax_api_sweeps
    from mlcomp_tpu_torch.__main__ import main as port_main
    from mlcomp_tpu_torch.server.api import api_sweeps
    twin = SweepTwin(tmp_path)
    try:
        running = _front_two(twin)
        for cell, value in zip(running, (0.9, 0.2)):
            twin.report(cell, 1, value, score=value)
        twin.tick()
        # a second sweep, finished
        jax_dag_standard(twin.jax, copy.deepcopy(SWEEP_CONFIG))
        dag_standard(twin.port, copy.deepcopy(SWEEP_CONFIG))
        twin.both("UPDATE sweep SET status='done', best_task=?, "
                  "best_score=0.5 WHERE id=2", (running[0],))
        for flag in (False, True):
            mine = api_sweeps({'all': flag}, twin.port)
            assert _without_time(mine) == _without_time(
                jax_api_sweeps({'all': flag}, twin.jax))
            assert len(mine['data']) == 1 + flag
        entry = api_sweeps({}, twin.port)['data'][0]
        assert entry['rungs'] == [{'rung': 0, 'promoted': 1, 'pruned': 1}]
        outs = {}
        for flags in (['--json'], ['--json', '--all'], [], ['--all']):
            JaxSession.cleanup('default')
            Session.cleanup('default')
            monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING',
                                twin.jax_cs)
            monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                                twin.port_cs)
            try:
                theirs = CliRunner().invoke(jax_main, ['sweeps', *flags])
                assert theirs.exit_code == 0, theirs.output
                capsys.readouterr()
                port_main(['sweeps', *flags])
                mine = capsys.readouterr().out
            finally:
                JaxSession.cleanup('default')
                Session.cleanup('default')
            if '--json' in flags:
                assert _without_time(json.loads(mine)) == \
                    _without_time(json.loads(theirs.output))
            else:
                assert mine == theirs.output
            outs[tuple(flags)] = mine
        assert 'pruned at rung 0 (0.2 vs cutoff 0.9)' in outs[()]
        assert '[done]' in outs[('--all',)] and '[done]' not in outs[()]
    finally:
        twin.close()


def test_an_empty_db_says_no_sweeps(tmp_path, monkeypatch, capsys):
    import mlcomp_tpu_torch
    from mlcomp_tpu_torch.__main__ import main as port_main
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                        f'sqlite:///{tmp_path}/empty.db')
    Session.cleanup('default')
    try:
        port_main(['sweeps'])
        port_main(['sweeps', '--all'])
        assert capsys.readouterr().out == 'no active sweeps\nno sweeps\n'
    finally:
        Session.cleanup('default')


# ------------------------------------------------------------- end to end
HOST = hostname()


def _worker_loop(worker_id, cs, queue, epochs, epoch_s, stop_evt):
    """tests/test_sweep.py's pool slot on the port: claim, 'train'
    (sleep, deterministic ``probe_score`` reports an epoch), notice a
    prune, finish."""
    sess = Session.create_session(key=f'sweep_pool_{worker_id}',
                                  connection_string=cs)
    qp, tp = QueueProvider(sess), TaskProvider(sess)
    me = f'pool:{worker_id}'
    try:
        while not stop_evt.is_set():
            claim = qp.claim([queue], me)
            if claim is None:
                time.sleep(0.01)
                continue
            msg_id, payload = claim
            if payload.get('action') != 'execute':
                qp.complete(msg_id, worker=me)
                continue
            task = tp.by_id(payload['task_id'])
            if task is None or task.status > int(TaskStatus.Queued):
                qp.complete(msg_id, worker=me)
                continue
            tp.change_status(task, TaskStatus.InProgress)
            cell = (yaml_load(task.additional_info) or {}).get('grid') or {}
            lr, seed = float(cell.get('lr', 0.1)), int(cell.get('seed', 0))
            best = None
            for epoch in range(1, epochs + 1):
                time.sleep(epoch_s)
                row = tp.by_id(task.id)
                if row is None or row.status >= int(TaskStatus.Failed):
                    break               # pruned mid-run
                score = probe_score(lr, seed, epoch)
                if best is None or score > best:
                    best = score
                    task.score = float(score)
                    tp.update(task, ['score'])
                asha.report_sweep_score(sess, task.id, epoch, score)
            row = tp.by_id(task.id)
            if row is not None and row.status < int(TaskStatus.Failed):
                tp.change_status(row, TaskStatus.Success)
            qp.complete(msg_id, worker=me)
    finally:
        Session.cleanup(sess.key)


def test_six_cell_sweep_prunes_and_keeps_the_best(tmp_path):
    """tests/test_sweep.py's six-cell leg through the port's supervisor
    loop (50 ms backstop) and a two-slot threaded pool: prunes happen,
    each audited once, none retried, the others succeed, and the best
    equals the analytic exhaustive best."""
    from mlcomp_tpu_torch.db.models import Computer
    from mlcomp_tpu_torch.db.providers import (
        ComputerProvider, DockerProvider,
    )
    cs = f'sqlite:///{tmp_path}/e2e.db'
    session = Session.create_session(key=f'e2e-{tmp_path}',
                                     connection_string=cs)
    migrate(session)
    ComputerProvider(session).create_or_update(Computer(
        name=HOST, cores=2, cpu=16, memory=64, ip='127.0.0.1',
        can_process_tasks=True), 'name')
    DockerProvider(session).heartbeat(HOST, 'default')
    epochs, stop_evt = 4, threading.Event()
    workers = [threading.Thread(
        target=_worker_loop, args=(f'{tmp_path.name}_{i}', cs,
                                   f'{HOST}_default', epochs, 0.10,
                                   stop_evt), daemon=True)
        for i in range(2)]
    builder = SupervisorBuilder(session=Session.create_session(
        key=f'e2e-sup-{tmp_path}', connection_string=cs))
    loop = SupervisorLoop(builder, interval=0.05)
    dag, tasks = dag_standard(session, copy.deepcopy(SWEEP_CONFIG))
    cell_ids = tasks['cells']
    loop.start()
    for w in workers:
        w.start()
    tp = TaskProvider(session)
    finished = {int(s) for s in TaskStatus.finished()}
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if all(tp.by_id(t).status in finished for t in cell_ids):
                break
            time.sleep(0.05)
        else:
            raise TimeoutError('the sweep did not finish')
    finally:
        stop_evt.set()
        loop.stop()
        loop.join(timeout=10)
        for w in workers:
            w.join(timeout=10)
    try:
        builder.build()
        cells = [tp.by_id(t) for t in cell_ids]
        pruned = [c for c in cells if c.failure_reason == SWEEP_PRUNED_REASON]
        sweep = SweepProvider(session).by_dag(dag.id)[0]
        prunes = [d for d in SweepDecisionProvider(session).for_sweep(
            sweep.id) if d.verdict == 'prune']
        assert pruned and sorted(d.task for d in prunes) == \
            sorted(c.id for c in pruned)
        assert all((c.attempt or 0) == 0 and c.next_retry_at is None
                   for c in pruned)
        assert all(c.status == int(TaskStatus.Success)
                   for c in cells if c not in pruned)
        true_best = max(probe_score(lr, seed, epochs)
                        for seed in range(3) for lr in (0.05, 0.1))
        assert max(c.score for c in cells if c.score is not None) == \
            pytest.approx(true_best, abs=1e-9)
        done = SweepProvider(session).by_id(sweep.id)
        assert done.status == 'done'
        assert done.best_score == pytest.approx(true_best, abs=1e-9)
    finally:
        Session.cleanup(builder.raw_session.key)
        Session.cleanup(session.key)


#: a sweep cell that reports once and then sleeps without polling: only
#: a signal ends it
HANG_EXECUTOR = '''
import time

from mlcomp_tpu_torch.contrib.search.asha import report_sweep_score
from mlcomp_tpu_torch.worker.executors import Executor


@Executor.register
class SweepHang(Executor):
    def __init__(self, value=0.1, **kwargs):
        self.value = float(value)

    def work(self):
        report_sweep_score(self.session, self.task.id, 1, self.value)
        time.sleep(120)
        return {}
'''


def test_a_pruned_run_task_process_keeps_its_verdict(tmp_path, monkeypatch):
    """The prune SIGTERMs the cell's ``run-task`` process, which exits
    143; the worker's post-exit verdict leaves the row
    ``Failed``/``sweep-pruned``, and later ticks neither retry it nor
    hold its slot."""
    from tests.test_torch_port_worker import _consume
    import mlcomp_tpu_torch
    import mlcomp_tpu_torch.worker.__main__ as wm
    import mlcomp_tpu_torch.worker.storage as storage
    from mlcomp_tpu_torch.db.providers import DockerProvider
    from mlcomp_tpu_torch.utils.io import yaml_dump
    root = tmp_path / 'root'
    monkeypatch.setenv('MLCOMP_TPU_ROOT', str(root))
    monkeypatch.setenv('MLCOMP_HOSTNAME', 'host1')
    monkeypatch.setenv('PYTHONPATH', REPO)
    monkeypatch.setattr(wm, 'HOSTNAME', 'host1')
    for name, sub in (('TASK_FOLDER', 'tasks'), ('DATA_FOLDER', 'data'),
                      ('MODEL_FOLDER', 'models')):
        monkeypatch.setattr(mlcomp_tpu_torch, name, str(root / sub))
        monkeypatch.setattr(storage, name, str(root / sub))
    url = f'sqlite:///{root}/db/sqlite.db'
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING', url)
    Session.cleanup('default')
    session = Session.create_session(key=f'hang-{tmp_path}',
                                     connection_string=url)
    try:
        migrate(session)
        wm.register_computer(session, cores=1)
        DockerProvider(session).heartbeat('host1', 'default')
        config = {'info': {'name': 'hang', 'project': 'p_hang'},
                  'executors': {'cells': {
                      'type': 'sweep_hang', 'cores': 1,
                      'grid': [{'value': [0.1, 0.9]}],
                      'sweep': {'metric': 'score', 'rung_epochs': 1}}}}
        folder = tmp_path / 'code'
        folder.mkdir()
        (folder / 'executors.py').write_text(HANG_EXECUTOR)
        (folder / 'config.yml').write_text(yaml_dump(config))
        _, tasks = dag_standard(session, config, upload_folder=str(folder))
        loser, other = tasks['cells']
        sup = SupervisorBuilder(session=session)
        sup.build()
        provider = TaskProvider(session)
        assert provider.by_id(loser).status == int(TaskStatus.Queued)
        asha.report_sweep_score(session, other, 1, 0.9)
        consumed = threading.Thread(target=_consume,
                                    args=(session, False))
        consumed.start()
        deadline = time.monotonic() + 60
        while not session.query_one(
                'SELECT 1 FROM metric WHERE name=? AND task=?',
                (asha.SWEEP_SCORE_METRIC, loser)):
            assert time.monotonic() < deadline, 'the cell never reported'
            time.sleep(0.1)
        t_prune = time.monotonic()
        sup.build()
        consumed.join(timeout=60)
        assert not consumed.is_alive()
        assert time.monotonic() - t_prune < 30
        msg = session.query_one('SELECT status, result FROM queue_message '
                                'WHERE id=?',
                                (provider.by_id(loser).queue_id,))
        assert tuple(msg) == ('failed', 'subprocess failed (rc=143)')
        for _ in range(3):
            sup.build()
        row = provider.by_id(loser)
        assert (row.status, row.failure_reason, row.attempt or 0,
                row.next_retry_at) == (int(TaskStatus.Failed),
                                       SWEEP_PRUNED_REASON, 0, None)
        prunes = SweepDecisionProvider(session).for_sweep(1)
        assert sorted((d.task, d.verdict) for d in prunes) == [
            (loser, 'prune'), (other, 'promote')]
        # the freed slot went to the other cell
        assert provider.by_id(other).status == int(TaskStatus.Queued)
    finally:
        Session.cleanup(session.key)
        Session.cleanup('default')

"""The port's worker daemon on the CPU, and the slice whole: a DAG
submitted with ``dag`` reaches Success through supervisor ticks and the
worker's consume loop, in-process and in ``run-task`` processes, with
the metric series ``execute`` of the same config gives; the same DAG
through the JAX package's supervisor and worker gives the same
statuses, failure reasons and dispatch decisions. Also: a task process
that fails gives ``classify_returncode``'s taxonomy, the dead-pid
reaper's grace window, a kill routed through the control queue (and
the pid-reuse guard), a worker SIGKILLed mid-task reaped as
``worker-lost``, retried and ending Success, a second stage requeued to
the worker's own queue, FileSync against JAX's, the ``/proc`` telemetry
against the JAX package's plain fallbacks, the scheduled jobs and the
autorestarting process group."""

import datetime
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

# imported here, not under the ``daemon`` fixture: the JAX worker binds
# its HOSTNAME at import, and a binding to the fixture's 'host1' would
# outlive this file in the process
import mlcomp_tpu.worker.__main__ as jax_wm
import mlcomp_tpu_torch
import mlcomp_tpu_torch.worker.__main__ as wm
import mlcomp_tpu_torch.worker.storage as storage
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import Computer
from mlcomp_tpu_torch.db.providers import (
    ComputerProvider, DockerProvider, QueueProvider, TaskProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.server.supervisor import SupervisorBuilder
from mlcomp_tpu_torch.utils import procfs
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.logging import create_logger
from mlcomp_tpu_torch.utils.misc import now

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPORT = 'from mlcomp_tpu.worker.executors import Executor'
PORT_IMPORT = 'from mlcomp_tpu_torch.worker.executors import Executor'

#: one executor of many behaviours, for both packages (the import line
#: is the package's)
PROBE = '''
import os
import time
from mlcomp_tpu.worker.executors import Executor


@Executor.register
class DaemonProbe(Executor):
    def __init__(self, mode='ok', marker=None, **kwargs):
        self.mode, self.marker = mode, marker

    def work(self):
        if self.mode == 'raise':
            raise RuntimeError('probe failed')
        if self.mode == 'sigkill':
            os.kill(os.getpid(), 9)
        if self.mode == 'exit':
            os._exit(3)
        if self.mode == 'hang_once' and not os.path.exists(self.marker):
            open(self.marker, 'w').close()
            time.sleep(120)
        return {'pid': os.getpid()}
'''

#: the recovery knobs of the SIGKILL test: a 60 s backoff
RECOVERY = {'lease_seconds': 60, 'backoff_base_s': 60, 'max_retries': 3}


def _folder(tmp_path, package: str, config: dict):
    folder = tmp_path / f'{package}_code'
    folder.mkdir(exist_ok=True)
    source = PROBE if package == 'jax' else PROBE.replace(JAX_IMPORT,
                                                          PORT_IMPORT)
    (folder / 'executors.py').write_text(source)
    (folder / 'config.yml').write_text(yaml_dump(config))
    return folder


def _probe_config(**executors) -> dict:
    return {'info': {'name': 'probe', 'project': 'p_probe'},
            'executors': {name: {'type': 'daemon_probe', **spec}
                          for name, spec in executors.items()}}


@pytest.fixture()
def daemon(tmp_path, monkeypatch):
    """A root of the test's own (its DB, tasks, data and models) that
    ``run-task`` processes find through ``MLCOMP_TPU_ROOT``; this host
    is 'host1', registered with one card and heartbeating."""
    root = tmp_path / 'root'
    monkeypatch.setenv('MLCOMP_TPU_ROOT', str(root))
    monkeypatch.setenv('MLCOMP_HOSTNAME', 'host1')
    monkeypatch.setenv('PYTHONPATH', REPO)
    monkeypatch.setattr(wm, 'HOSTNAME', 'host1')
    for name, folder in (('TASK_FOLDER', 'tasks'), ('DATA_FOLDER', 'data'),
                         ('MODEL_FOLDER', 'models')):
        monkeypatch.setattr(mlcomp_tpu_torch, name, str(root / folder))
        monkeypatch.setattr(storage, name, str(root / folder))
    url = f'sqlite:///{root}/db/sqlite.db'
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING', url)
    Session.cleanup('default')
    session = Session.create_session(key=f'daemon-{tmp_path}',
                                     connection_string=url)
    migrate(session)
    wm.register_computer(session, cores=1)
    DockerProvider(session).heartbeat('host1', 'default')
    yield session
    Session.cleanup(session.key)
    Session.cleanup('default')


def _submit(session, tmp_path, config):
    folder = _folder(tmp_path, 'port', config)
    _, tasks = dag_standard(session, config, upload_folder=str(folder))
    return {name: ids[0] for name, ids in tasks.items()}


def _consume(session, in_process: bool) -> bool:
    return wm._consume_one(session, QueueProvider(session),
                           create_logger(session), 0, in_process)


@pytest.mark.parametrize('in_process', [True, False],
                         ids=['in_process', 'run_task'])
def test_consume_one_runs_the_task_in_the_submissions_trace(
        daemon, tmp_path, in_process):
    ids = _submit(daemon, tmp_path, _probe_config(probe={}))
    SupervisorBuilder(session=daemon).build()
    task = TaskProvider(daemon).by_id(ids['probe'])
    trace = yaml_load(task.additional_info)['trace_id']
    msg = daemon.query_one('SELECT * FROM queue_message')
    assert json.loads(msg['payload'])['trace_id'] == trace
    assert _consume(daemon, in_process)
    assert not _consume(daemon, in_process)      # the queue is empty
    task = TaskProvider(daemon).by_id(ids['probe'])
    assert task.status == int(TaskStatus.Success), task.result
    assert (json.loads(task.result)['pid'] == os.getpid()) == in_process
    assert (task.worker_index, task.computer_assigned) == (0, 'host1')
    msg = daemon.query_one('SELECT * FROM queue_message')
    assert (msg['status'], msg['claimed_by']) == ('done', 'host1:0')
    spans = daemon.query('SELECT name, trace_id, process_role FROM '
                         'telemetry_span WHERE task=?', (task.id,))
    names = {r['name'] for r in spans}
    assert {'supervisor.dispatch', 'task.pipeline', 'task.execute'} <= names
    assert {r['trace_id'] for r in spans} == {trace}
    assert {r['process_role'] for r in spans} >= {'supervisor', 'worker'}


@pytest.mark.parametrize('mode, reason, rc', [
    ('raise', 'executor-error', 1), ('sigkill', 'preempted', -9),
    ('exit', 'worker-lost', 3)])
def test_a_failing_task_process_gives_the_taxonomy(daemon, tmp_path, mode,
                                                   reason, rc):
    ids = _submit(daemon, tmp_path, _probe_config(probe={'mode': mode}))
    SupervisorBuilder(session=daemon).build()
    assert _consume(daemon, in_process=False)
    task = TaskProvider(daemon).by_id(ids['probe'])
    assert (task.status, task.failure_reason) == (int(TaskStatus.Failed),
                                                  reason)
    msg = daemon.query_one('SELECT status, result FROM queue_message')
    assert tuple(msg) == ('failed', f'subprocess failed (rc={rc})')


def test_a_restart_landing_as_the_process_exits_is_kept(daemon, tmp_path,
                                                          monkeypatch):
    """``/api/dag/start`` resets a stopped task while its killed
    ``run-task`` process exits: the worker's post-exit verdict (a signal
    kill reads as ``preempted``) must not overwrite the reset, or the
    restart is lost. A process that dies with the row still its claim's
    is classified as before."""
    from mlcomp_tpu_torch.recovery import reset_for_requeue
    ids = _submit(daemon, tmp_path, _probe_config(probe={}))
    SupervisorBuilder(session=daemon).build()
    provider = TaskProvider(daemon)

    def killed_then_restarted(task_id, index, trace_id=None):
        task = provider.by_id(task_id)
        provider.change_status(task, TaskStatus.Stopped)
        reset_for_requeue(provider, task, resume={'master_task_id': 1},
                          reset_attempts=True)
        return -15

    monkeypatch.setattr(wm, '_run_subprocess', killed_then_restarted)
    assert _consume(daemon, in_process=False)
    task = provider.by_id(ids['probe'])
    assert (task.status, task.failure_reason, task.queue_id) == (
        int(TaskStatus.NotRan), None, None)
    assert yaml_load(task.additional_info)['resume'] == {'master_task_id': 1}
    # re-dispatched and killed with the row still its claim's: preempted
    SupervisorBuilder(session=daemon).build()
    monkeypatch.setattr(wm, '_run_subprocess', lambda *a, **k: -15)
    assert _consume(daemon, in_process=False)
    task = provider.by_id(ids['probe'])
    assert (task.status, task.failure_reason) == (int(TaskStatus.Failed),
                                                  'preempted')


def _dead_pid() -> int:
    proc = subprocess.Popen(['true'])
    proc.wait()
    return proc.pid


def test_the_reaper_waits_out_its_grace_window(daemon, tmp_path):
    ids = _submit(daemon, tmp_path, _probe_config(
        fresh={}, silent={}, alive={}, elsewhere={}))
    provider = TaskProvider(daemon)
    quiet = now() - datetime.timedelta(seconds=60)
    for name, pid, computer, silent in (
            ('fresh', _dead_pid(), 'host1', False),
            ('silent', _dead_pid(), 'host1', True),
            ('alive', os.getpid(), 'host1', True),
            ('elsewhere', _dead_pid(), 'host2', True)):
        task = provider.by_id(ids[name])
        task.pid, task.computer_assigned = pid, computer
        provider.update(task, ['pid', 'computer_assigned'])
        provider.change_status(task, TaskStatus.InProgress)
        if silent:
            daemon.execute('UPDATE task SET last_activity=? WHERE id=?',
                           (quiet, task.id))
    wm.stop_processes_not_exist(daemon, create_logger(daemon))
    got = {name: (provider.by_id(i).status, provider.by_id(i).failure_reason)
           for name, i in ids.items()}
    running = (int(TaskStatus.InProgress), None)
    assert got == {'fresh': running, 'alive': running, 'elsewhere': running,
                   'silent': (int(TaskStatus.Failed), 'worker-lost')}


def _sleeper(task_id: int):
    env = {**os.environ, 'MLCOMP_TASK_ID': str(task_id)}
    return subprocess.Popen([sys.executable, '-c',
                             'import time; time.sleep(60)'], env=env)


def test_a_kill_routed_through_the_control_queue(daemon, tmp_path,
                                                 monkeypatch):
    from mlcomp_tpu_torch.worker.tasks import kill_task
    ids = _submit(daemon, tmp_path, _probe_config(victim={}, other={}))
    provider = TaskProvider(daemon)
    victim = _sleeper(ids['victim'])
    reused = _sleeper(ids['other'])     # a pid now another task's
    try:
        for name, proc in (('victim', victim), ('other', reused)):
            task = provider.by_id(ids[name])
            task.pid, task.computer_assigned = proc.pid, 'host1'
            provider.update(task, ['pid', 'computer_assigned'])
            provider.change_status(task, TaskStatus.InProgress)
        # another host stops the victim: the kill is routed to host1
        monkeypatch.setenv('MLCOMP_HOSTNAME', 'supervisor-host')
        assert kill_task(ids['victim'], session=daemon)
        assert victim.poll() is None
        msg = daemon.query_one('SELECT * FROM queue_message')
        assert (msg['queue'], json.loads(msg['payload'])) == (
            'host1_default_supervisor',
            {'action': 'kill', 'task_id': ids['victim']})
        assert provider.by_id(ids['victim']).status == \
            int(TaskStatus.Stopped)
        monkeypatch.setenv('MLCOMP_HOSTNAME', 'host1')
        wm.consume_control_queue(daemon, create_logger(daemon))
        assert victim.wait(timeout=10) == -signal.SIGTERM
        assert daemon.query_one('SELECT status FROM queue_message')[0] == \
            'done'
        # the pid-reuse guard: the victim's row now names a pid that runs
        # the other task's process (its marker says so): nothing dies
        daemon.execute('UPDATE task SET pid=? WHERE id=?',
                       (reused.pid, ids['victim']))
        provider.change_status(provider.by_id(ids['victim']),
                               TaskStatus.InProgress)
        kill_task(ids['victim'], session=daemon)
        time.sleep(0.2)
        assert reused.poll() is None
    finally:
        for proc in (victim, reused):
            proc.kill()
            proc.wait()


def test_a_sigkilled_worker_is_reaped_retried_and_succeeds(daemon,
                                                           tmp_path):
    marker = tmp_path / 'started'
    ids = _submit(daemon, tmp_path, _probe_config(
        train={'mode': 'hang_once', 'marker': str(marker)}))
    provider = TaskProvider(daemon)
    sup = SupervisorBuilder(session=daemon,
                            recovery_config=RecoveryConfig(**RECOVERY))
    sup.build()
    worker = subprocess.Popen(
        [sys.executable, '-m', 'mlcomp_tpu_torch.worker', 'worker', '0'],
        cwd=REPO, start_new_session=True, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while not marker.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        task = provider.by_id(ids['train'])
        assert marker.exists() and task.status == \
            int(TaskStatus.InProgress)
    finally:
        os.killpg(worker.pid, signal.SIGKILL)   # the worker and its task
        worker.wait(timeout=10)
    # SIGKILL lands asynchronously: wait for the task process to die
    deadline = time.monotonic() + 10
    while procfs.pid_exists(task.pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    daemon.execute('UPDATE task SET last_activity=? WHERE id=?',
                   (now() - datetime.timedelta(seconds=60), task.id))
    wm.stop_processes_not_exist(daemon, create_logger(daemon))
    task = provider.by_id(ids['train'])
    assert (task.status, task.failure_reason) == (int(TaskStatus.Failed),
                                                  'worker-lost')
    sup.build()                                 # schedules the backoff
    daemon.execute('UPDATE task SET next_retry_at=? WHERE id=?',
                   (now() - datetime.timedelta(seconds=10), task.id))
    sup.build()                                 # requeues and re-places
    task = provider.by_id(ids['train'])
    assert (task.status, task.attempt) == (int(TaskStatus.Queued), 1)
    info = yaml_load(task.additional_info)
    assert info['resume']['master_task_id'] == task.id
    assert info['retry_exclude'] == ['host1']   # soft: the only host
    assert _consume(daemon, in_process=True)
    task = provider.by_id(ids['train'])
    assert (task.status, task.failure_reason) == (int(TaskStatus.Success),
                                                  None)
    assert daemon.query_one("SELECT COUNT(*) FROM metric WHERE "
                            "name='task.retry'")[0] == 1


# ------------------------------------------------------------- the slice
def _mlp_config() -> dict:
    return {'info': {'name': 'mlp_daemon', 'project': 'mlp_daemon'},
            'executors': {'train': {
                'type': 'jax_train',
                'model': {'name': 'mlp', 'num_classes': 10},
                'dataset': {'name': 'synthetic_images', 'n_train': 64,
                            'n_valid': 32, 'image_size': 8, 'channels': 1,
                            'num_classes': 10},
                'batch_size': 16, 'device': 'cpu', 'model_name': 'mlp_d',
                'stages': [{'name': 's1', 'epochs': 2, 'optimizer': {
                    'name': 'adam', 'lr': 0.001}}]}}}


def _series(session) -> list:
    return [tuple(r) for r in session.query(
        'SELECT name, part, stage, epoch, value FROM report_series '
        'ORDER BY name, part, epoch')]


#: the series of the run-task process and of execute in the test process
#: may sum in other orders (their torch thread counts differ)
SERIES_RTOL = 1e-5


@pytest.mark.parametrize('in_process', [True, False],
                         ids=['in_process', 'run_task'])
def test_a_submitted_dag_runs_to_success_as_execute_runs_it(
        daemon, tmp_path, monkeypatch, capsys, in_process):
    from mlcomp_tpu_torch.__main__ import main
    folder = tmp_path / 'mlp'
    folder.mkdir()
    (folder / 'config.yml').write_text(yaml_dump(_mlp_config()))
    main(['dag', str(folder / 'config.yml')])
    assert 'created with 1 tasks' in capsys.readouterr().out
    sup = SupervisorBuilder(session=daemon)
    for _ in range(3):
        sup.build()
        while _consume(daemon, in_process):
            pass
    statuses = [r[0] for r in daemon.query('SELECT status FROM task')]
    assert statuses == [int(TaskStatus.Success)]
    mine = _series(daemon)
    # execute of the same config, on a DB and a task folder of its own
    # (the same task id would resume the run above's checkpoint)
    Session.cleanup('default')
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                        f'sqlite:///{tmp_path}/execute.db')
    monkeypatch.setattr(mlcomp_tpu_torch, 'TASK_FOLDER',
                        str(tmp_path / 'execute_tasks'))
    assert main(['execute', str(folder / 'config.yml')]) == {
        'train': 'Success'}
    theirs = _series(Session.create_session())
    assert [r[:4] for r in mine] == [r[:4] for r in theirs]
    assert len(mine) == 10        # 2 epochs x (loss, accuracy) x 2 + rate
    for a, b in zip(mine, theirs):
        if a[0] != 'images_per_sec':
            np.testing.assert_allclose(a[4], b[4], rtol=SERIES_RTOL)


def test_the_same_dag_through_jax_gives_the_same_decisions(
        daemon, tmp_path, monkeypatch):
    from mlcomp_tpu.db.core import Session as JaxSession
    from mlcomp_tpu.db.migration import migrate as jax_migrate
    from mlcomp_tpu.db.models import Computer as JaxComputer
    from mlcomp_tpu.db.providers import (
        DockerProvider as JaxDocker, QueueProvider as JaxQueue,
    )
    from mlcomp_tpu.server.create_dags.standard import (
        dag_standard as jax_dag_standard,
    )
    from mlcomp_tpu.server.supervisor import (
        SupervisorBuilder as JaxSupervisor,
    )
    from mlcomp_tpu.utils.logging import create_logger as jax_logger
    monkeypatch.setattr(jax_wm, 'HOSTNAME', 'host1')
    config = _probe_config(a={}, b={'depends': 'a'}, c={'mode': 'raise'},
                           d={'depends': 'c'}, e={'depends': ['a', 'b']})
    jax = JaxSession.create_session(
        key=f'jax-{tmp_path}', connection_string=f'sqlite:///{tmp_path}/j.db')
    try:
        jax_migrate(jax)
        jax.add(JaxComputer(name='host1', cores=1, cpu=16, memory=64.0,
                            ip='127.0.0.1', can_process_tasks=True))
        JaxDocker(jax).heartbeat('host1', 'default')
        jax_dag_standard(jax, config, upload_folder=str(
            _folder(tmp_path, 'jax', config)))
        _submit(daemon, tmp_path, config)
        ComputerProvider(daemon).create_or_update(Computer(
            name='host1', cores=1, cpu=16, memory=64.0, ip='127.0.0.1',
            can_process_tasks=True), 'name')
        runs = []
        for session, sup, consume in (
                (jax, JaxSupervisor(session=jax),
                 lambda: jax_wm._consume_one(jax, JaxQueue(jax),
                                             jax_logger(jax), 0, True)),
                (daemon, SupervisorBuilder(session=daemon),
                 lambda: _consume(daemon, True))):
            names = {r['id']: r['name'] for r in session.query(
                'SELECT id, name FROM task')}
            decisions = []
            for _ in range(6):
                sup.build()
                decisions.append(sorted(
                    (names[d['task']], d['queue'], tuple(d['cores']))
                    for d in sup.aux.get('dispatched', [])))
                while consume():
                    pass
            runs.append((decisions, sorted(
                (r['name'], r['status'], r['failure_reason'])
                for r in session.query('SELECT * FROM task'))))
    finally:
        JaxSession.cleanup(jax.key)
    assert runs[1] == runs[0]
    assert runs[1][1] == [
        ('a', int(TaskStatus.Success), None),
        ('b', int(TaskStatus.Success), None),
        ('c', int(TaskStatus.Failed), 'executor-error'),
        ('d', int(TaskStatus.Skipped), None),
        ('e', int(TaskStatus.Success), None)]


def test_a_second_stage_is_requeued_to_the_workers_own_queue(
        daemon, tmp_path):
    """``stage_per_dispatch``: each stage ends by requeueing the task on
    ``<host>_<docker>_<index>``, which only that worker consumes."""
    config = _mlp_config()
    train = config['executors']['train']
    train['stage_per_dispatch'] = True
    train['stages'] = [{'name': 's1', 'epochs': 1, 'optimizer': {
        'name': 'adam', 'lr': 0.001}}, {'name': 's2', 'epochs': 1,
                                        'optimizer': {'name': 'sgd',
                                                      'lr': 0.01}}]
    (task_id,) = _submit(daemon, tmp_path, config).values()
    SupervisorBuilder(session=daemon).build()
    assert _consume(daemon, in_process=True)
    task = TaskProvider(daemon).by_id(task_id)
    assert task.status == int(TaskStatus.Queued)
    msg = daemon.query_one('SELECT * FROM queue_message WHERE id=?',
                           (task.queue_id,))
    assert (msg['queue'], msg['status']) == ('host1_default_0', 'pending')
    assert _consume(daemon, in_process=True)
    task = TaskProvider(daemon).by_id(task_id)
    assert task.status == int(TaskStatus.Success)
    assert [r[0] for r in daemon.query(
        "SELECT stage FROM report_series WHERE name='loss' AND "
        "part='train' ORDER BY id")] == ['s1', 's2']


def test_file_sync_marks_what_jax_marks(daemon, tmp_path):
    """On shared storage (no rsync) a pass marks every successful task
    of another computer synced, as JAX's FileSync does on a twin DB."""
    import shutil
    from mlcomp_tpu.db.core import Session as JaxSession
    from mlcomp_tpu.worker.sync import FileSync as JaxFileSync
    from mlcomp_tpu_torch.db.providers import TaskSyncedProvider
    from mlcomp_tpu_torch.worker.sync import FileSync
    ids = _submit(daemon, tmp_path, _probe_config(
        remote={}, local={}, failed={}))
    for name, computer, status in (
            ('remote', 'host2', TaskStatus.Success),
            ('local', 'host1', TaskStatus.Success),
            ('failed', 'host2', TaskStatus.Failed)):
        daemon.execute('UPDATE task SET computer_assigned=?, status=? '
                       'WHERE id=?', (computer, int(status), ids[name]))
    url = daemon.connection_string
    Session.cleanup(daemon.key)
    shutil.copy(url[len('sqlite:///'):], tmp_path / 'jax.db')
    daemon = Session.create_session(key=daemon.key, connection_string=url)
    jax = JaxSession.create_session(
        key=f'sync-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/jax.db')
    try:
        assert FileSync(session=daemon).sync() == \
            JaxFileSync(session=jax).sync() == 1
        rows = [tuple(r) for r in daemon.query(
            'SELECT computer, task FROM task_synced ORDER BY id')]
        assert rows == [tuple(r) for r in jax.query(
            'SELECT computer, task FROM task_synced ORDER BY id')]
        assert rows == [('host1', ids['remote'])]
    finally:
        JaxSession.cleanup(jax.key)
    # what the executors' barrier waits on is gone
    assert TaskSyncedProvider(daemon).for_computer('host1') == []


def test_procfs_reads_as_the_native_fallbacks(tmp_path):
    """The host telemetry against ``mlcomp_tpu/native``'s plain-Python
    fallbacks over the same ``/proc`` and ``statvfs`` sources (memory
    within 2 points: the host moves between the reads)."""
    from mlcomp_tpu import native
    assert procfs.disk_percent(str(tmp_path)) == pytest.approx(
        native.disk_percent(str(tmp_path)), abs=1.0)
    assert procfs.memory_percent() == pytest.approx(
        native.memory_percent(), abs=2.0)
    assert 0.0 <= procfs.cpu_percent() <= 100.0
    assert procfs.pid_exists(os.getpid()) and not procfs.pid_exists(
        _dead_pid())


def test_scheduled_jobs_run_and_survive_a_failure():
    from mlcomp_tpu_torch.utils.schedule import start_schedule
    runs = []

    def tick():
        runs.append(1)

    def boom():
        raise RuntimeError('a failing job')

    jobs = start_schedule([(tick, 0.01), (boom, 0.01)])
    deadline = time.monotonic() + 10
    while len(runs) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    for job in jobs:
        job.stop()
        job.join(timeout=5)
    assert len(runs) >= 3 and all(job.is_alive() is False for job in jobs)


def test_the_process_group_restarts_a_child_that_exits():
    import threading
    from mlcomp_tpu_torch.utils.procgroup import run_process_group
    marker = 'import time; time.sleep(600)  # procgroup probe'
    state, result = {'done': False}, {}

    def children():
        return [pid for pid in procfs.child_pids(os.getpid())
                if marker in procfs.process_cmdline(pid)
                and procfs.pid_exists(pid)]

    thread = threading.Thread(target=lambda: result.update(
        children=run_process_group(
            [['-c', marker]], poll_interval=0.1, install_signal=False,
            should_stop=lambda: state['done'])), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 20
        while not children() and time.monotonic() < deadline:
            time.sleep(0.05)
        (first,) = children()
        os.kill(first, signal.SIGTERM)
        fresh = []
        while not fresh and time.monotonic() < deadline + 20:
            time.sleep(0.1)
            fresh = [p for p in children() if p != first]
        assert fresh, 'the child was not restarted'
    finally:
        state['done'] = True
        thread.join(timeout=20)
    assert not thread.is_alive() and not children()

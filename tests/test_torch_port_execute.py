"""The port's task pipeline and ``execute`` command against the JAX
package's, on the CPU: a twin of ``examples/hierarchical_logging`` (its
``executors.py`` copied with the one import line changed) through both
packages' ``execute_by_id`` gives the same step tree and Log rows; a
raising executor ends ``Failed`` with the same reason and its dependant
``Skipped``, with the same last line from both command lines;
``python -m mlcomp_tpu_torch execute`` in a process of its own trains an
MLP with ``device: cpu`` (series under JAX's names, the export under the
project's models folder); ``stage_per_dispatch`` runs each stage once;
and the pipeline's refusals (no card, ``distr_info``, a library to
install). JAX's trainer is never the oracle here: it aborts under
pytest-xdist."""

import json
import os
import sqlite3
import subprocess
import sys

import pytest
import torch
import yaml
from click.testing import CliRunner

import mlcomp_tpu
import mlcomp_tpu_torch
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.server.create_dags.standard import (
    dag_standard as jax_dag_standard,
)
from mlcomp_tpu.worker.tasks import execute_by_id as jax_execute_by_id
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.providers import TaskProvider
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.worker.executors import Executor
from mlcomp_tpu_torch.worker.tasks import execute_by_id

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = os.path.join(REPO, 'examples', 'hierarchical_logging')
JAX_IMPORT = 'from mlcomp_tpu.worker.executors import Executor'
PORT_IMPORT = 'from mlcomp_tpu_torch.worker.executors import Executor'

#: the series the JAX trainer writes each epoch
#: (``mlcomp_tpu/train/executor.py:959-965``): every key of the train and
#: valid aggregates by part, and ``images_per_sec`` under ``train``
JAX_SERIES = {('loss', 'train'), ('accuracy', 'train'), ('loss', 'valid'),
              ('accuracy', 'valid'), ('images_per_sec', 'train')}


def _mlp_config(tmp_path, **spec):
    train = {'type': 'jax_train', 'model': {'name': 'mlp',
                                            'num_classes': 10},
             'dataset': {'name': 'synthetic_images', 'n_train': 64,
                         'n_valid': 32, 'image_size': 8, 'channels': 1,
                         'num_classes': 10},
             'batch_size': 16, 'device': 'cpu', 'model_name': 'mlp_model',
             'stages': [{'name': 's1', 'epochs': 1, 'optimizer': {
                 'name': 'adam', 'lr': 0.001}}]}
    train.update(spec)
    config = {'info': {'name': 'mlp_cpu', 'project': 'mlp_cpu',
                       'layout': 'classify'},
              'executors': {'train': train}}
    folder = tmp_path / 'mlp'
    folder.mkdir(exist_ok=True)
    with open(folder / 'config.yml', 'w') as fh:
        fh.write(yaml_dump(config))
    return config, folder


@pytest.fixture()
def port_session(tmp_path, monkeypatch):
    """A migrated DB of the test's own, and a task folder of its own (the
    sandbox's is shared with other tests: a checkpoint left under the
    same task id would be resumed)."""
    monkeypatch.setattr(mlcomp_tpu_torch, 'TASK_FOLDER',
                        str(tmp_path / 'tasks'))
    s = Session.create_session(
        key=f'exec-port-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/port.db')
    migrate(s)
    yield s
    Session.cleanup(s.key)


@pytest.fixture()
def jax_session(tmp_path):
    s = JaxSession.create_session(
        key=f'exec-jax-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/jax.db')
    jax_migrate(s)
    yield s
    JaxSession.cleanup(s.key)


def _twin(tmp_path, package: str, source: str, config: dict):
    """A folder with ``source`` as its executors.py (the import line the
    package's) and ``config`` as config.yml."""
    folder = tmp_path / f'{package}_twin'
    folder.mkdir()
    if package == 'port':
        assert JAX_IMPORT in source
        source = source.replace(JAX_IMPORT, PORT_IMPORT)
    (folder / 'executors.py').write_text(source)
    (folder / 'config.yml').write_text(yaml.safe_dump(config,
                                                      sort_keys=False))
    return folder


def step_tree(session, task_id):
    """(level, name, index, path of names from the root) of each step in
    creation order, and (step path, message, level, component) of each
    Log row."""
    paths, stack, tree = {}, [], []
    for r in session.query('SELECT * FROM step WHERE task=? ORDER BY id',
                           (task_id,)):
        while stack and stack[-1][0] >= r['level']:
            stack.pop()
        stack.append((r['level'], r['name']))
        paths[r['id']] = tuple(n for _, n in stack)
        tree.append((r['level'], r['name'], r['index'], paths[r['id']]))
    logs = [(paths.get(r['step']), r['message'], r['level'],
             r['component']) for r in session.query(
        'SELECT * FROM log WHERE task=? ORDER BY id', (task_id,))]
    return tree, logs


def test_hierarchical_twin_gives_jax_step_tree_and_logs(
        tmp_path, jax_session, port_session):
    source = open(os.path.join(HIER, 'executors.py')).read()
    config = yaml.safe_load(open(os.path.join(HIER, 'config.yml')))
    results = {}
    for package, session, build, run in (
            ('jax', jax_session, jax_dag_standard, jax_execute_by_id),
            ('port', port_session, dag_standard, execute_by_id)):
        folder = _twin(tmp_path, package, source, config)
        _, tasks = build(session, dict(config), upload_folder=str(folder))
        (task_id,) = tasks['demo']
        assert run(task_id, folder=str(folder),
                   session=session) == 'success'
        row = session.query_one('SELECT * FROM task WHERE id=?',
                                (task_id,))
        results[package] = (step_tree(session, task_id), row['status'],
                            row['result'], row['current_step'])
    assert results['port'] == results['jax']
    (tree, logs), status, result, _ = results['port']
    assert status == int(TaskStatus.Success)
    assert json.loads(result) == {'stages': 2, 'substeps': 3}
    assert [t[:2] for t in tree[:3]] == [(1, 'demo'), (1, 'stage 0'),
                                         (2, 'substep 0')]
    assert ('stage 1', 'substep 2') == logs[-1][0] and len(logs) == 8


_BOOM = f'''{JAX_IMPORT}


@Executor.register
class Boom(Executor):
    def work(self):
        raise ValueError('boom')


@Executor.register
class After(Executor):
    def work(self):
        return {{'ran': True}}
'''
_BOOM_CONFIG = {'info': {'name': 'boom', 'project': 'boom'},
                'executors': {'boom': {'type': 'boom'},
                              'after': {'type': 'after',
                                        'depends': 'boom'}}}


@pytest.fixture()
def default_dbs(tmp_path, monkeypatch):
    """Both packages' default sessions on files of their own."""
    for package, cls in ((mlcomp_tpu, JaxSession), (mlcomp_tpu_torch,
                                                    Session)):
        cls.cleanup('default')
        monkeypatch.setattr(package, 'SA_CONNECTION_STRING',
                            f'sqlite:///{tmp_path}/{package.__name__}.db')
    yield tmp_path
    JaxSession.cleanup('default')
    Session.cleanup('default')


def test_a_failure_skips_its_dependant_as_in_jax(tmp_path, default_dbs,
                                                 capsys):
    from mlcomp_tpu.__main__ import main as jax_main
    from mlcomp_tpu_torch.__main__ import main
    jax_folder = _twin(tmp_path, 'jax', _BOOM, _BOOM_CONFIG)
    port_folder = _twin(tmp_path, 'port', _BOOM, _BOOM_CONFIG)
    out = CliRunner().invoke(jax_main, ['execute',
                                        str(jax_folder / 'config.yml')])
    assert out.exit_code == 0, out.output
    theirs = out.output.strip().splitlines()[-1]
    capsys.readouterr()
    statuses = main(['execute', str(port_folder / 'config.yml')])
    mine = capsys.readouterr().out.strip().splitlines()[-1]
    assert mine == theirs
    assert json.loads(mine) == statuses == {'boom': 'Failed',
                                            'after': 'Skipped'}
    reasons = []
    for name in ('mlcomp_tpu', 'mlcomp_tpu_torch'):
        conn = sqlite3.connect(str(tmp_path / f'{name}.db'))
        reasons.append(conn.execute(
            "SELECT failure_reason FROM task WHERE name='boom'").fetchone())
        conn.close()
    assert reasons[0] == reasons[1] == ('executor-error',)


def test_execute_in_a_process_of_its_own(tmp_path):
    """``init`` then ``execute`` with ``device: cpu``: Success, the JAX
    trainer's series every epoch, the export under
    ``models/<project>/<model_name>``, spans and metric rows."""
    _, folder = _mlp_config(tmp_path, stages=[
        {'name': 's1', 'epochs': 2, 'optimizer': {'name': 'adam',
                                                  'lr': 0.001}}])
    root = tmp_path / 'root'
    env = {**os.environ, 'MLCOMP_TPU_ROOT': str(root), 'PYTHONPATH': REPO}
    for argv in (['init'], ['execute', str(folder / 'config.yml')]):
        proc = subprocess.run(
            [sys.executable, '-m', 'mlcomp_tpu_torch', *argv], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        'train': 'Success'}
    conn = sqlite3.connect(str(root / 'db' / 'sqlite.db'))
    series = conn.execute('SELECT name, part, epoch FROM report_series'
                          ).fetchall()
    assert {(n, p) for n, p, _ in series} == JAX_SERIES
    assert sorted({e for _, _, e in series}) == [0, 1]
    assert conn.execute('SELECT COUNT(*) FROM telemetry_span').fetchone()[
        0] > 0
    gauges = {n for (n,) in conn.execute('SELECT name FROM metric')}
    assert gauges == {'epoch_time_s', 'epoch_throughput'}
    score, = conn.execute('SELECT score_local FROM model WHERE '
                          "name='mlp_model'").fetchone()
    conn.close()
    assert 0 <= score <= 1
    export = root / 'models' / 'mlp_cpu' / 'mlp_model'
    assert (export.parent / 'mlp_model.msgpack').exists()
    for link in ('data', 'models'):
        assert os.path.islink(folder / link)


def test_stage_per_dispatch_runs_each_stage_once(tmp_path, port_session):
    config, folder = _mlp_config(tmp_path, stage_per_dispatch=True, stages=[
        {'name': 's1', 'epochs': 1, 'optimizer': {'name': 'adam',
                                                  'lr': 0.001}},
        {'name': 's2', 'epochs': 2, 'optimizer': {'name': 'sgd',
                                                  'lr': 0.01}}])
    _, tasks = dag_standard(port_session, config, debug=True)
    (task_id,) = tasks['train']
    assert execute_by_id(task_id, folder=str(folder),
                         session=port_session) == 'success'
    steps = [(r['level'], r['name']) for r in port_session.query(
        'SELECT * FROM step WHERE task=? ORDER BY id', (task_id,))]
    assert [n for lvl, n in steps if lvl == 1 and n.startswith('stage')] \
        == ['stage s1', 'stage s2']
    stages = [(r['stage'], r['epoch']) for r in port_session.query(
        "SELECT stage, epoch FROM report_series WHERE name='loss' AND "
        "part='train' ORDER BY id")]
    assert stages == [('s1', 0), ('s2', 1), ('s2', 2)]
    task = TaskProvider(port_session).by_id(task_id)
    assert yaml_load(task.additional_info)['stage'] == 's2'
    assert task.status == int(TaskStatus.Success)
    assert json.loads(task.result)['stage'] == 's2'


def _run_failing(port_session, config, folder, **edits):
    _, tasks = dag_standard(port_session, config, debug=True)
    (task_id,) = tasks['train']
    if edits:
        task = TaskProvider(port_session).by_id(task_id)
        for k, v in edits.items():
            setattr(task, k, v)
        TaskProvider(port_session).update(task, list(edits))
    return task_id


def test_without_device_cpu_the_trainer_raises_here(tmp_path, port_session):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    config, folder = _mlp_config(tmp_path)
    del config['executors']['train']['device']
    task_id = _run_failing(port_session, config, folder)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_by_id(task_id, folder=str(folder), session=port_session)
    task = TaskProvider(port_session).by_id(task_id)
    assert (task.status, task.failure_reason) == (
        int(TaskStatus.Failed), 'executor-error')


def test_a_distr_info_task_raises_naming_a4(tmp_path, port_session):
    config, folder = _mlp_config(tmp_path)
    task_id = _run_failing(port_session, config, folder,
                           additional_info=yaml_dump({'distr_info': {
                               'process_index': 0, 'process_count': 2}}))
    with pytest.raises(NotImplementedError, match='A4'):
        execute_by_id(task_id, folder=str(folder), session=port_session)
    assert TaskProvider(port_session).by_id(task_id).status == \
        int(TaskStatus.Failed)


def test_a_library_to_install_raises(tmp_path, port_session, monkeypatch):
    from mlcomp_tpu_torch.db.models import DagLibrary
    monkeypatch.setattr(mlcomp_tpu_torch, 'INSTALL_LIBRARIES', True)
    config, folder = _mlp_config(tmp_path)
    task_id = _run_failing(port_session, config, folder)
    dag = TaskProvider(port_session).by_id(task_id).dag
    port_session.add(DagLibrary(dag=dag, library='no-such-library',
                                version='1.0'))
    with pytest.raises(RuntimeError, match='no-such-library==1.0'):
        execute_by_id(task_id, folder=str(folder), session=port_session)


def test_pin_cores_sets_cuda_visible_devices(tmp_path, port_session,
                                             monkeypatch):
    from mlcomp_tpu_torch.worker.tasks import ExecuteBuilder
    monkeypatch.delenv('CUDA_VISIBLE_DEVICES', raising=False)
    config, folder = _mlp_config(tmp_path)
    task_id = _run_failing(port_session, config, folder,
                           cores_assigned='[2, 3]')
    builder = ExecuteBuilder(task_id, session=port_session)
    builder.create_base()
    builder.pin_cores()
    assert os.environ['CUDA_VISIBLE_DEVICES'] == '2,3'


@pytest.mark.parametrize('visible,cores,device', [
    (None, [1], 1),             # every card visible: its own index
    ('5,2', [2], 1),            # the card's index among the visible
    ('0', [1], None),           # the assigned card is not visible
    (None, [0, 1], None),       # two cards cannot be one current device
    ('0,1,2', [0, 1], None),
])
def test_pin_cores_once_cuda_runs(tmp_path, port_session, monkeypatch,
                                  visible, cores, device):
    """Where CUDA already runs in the process (an in-process worker), a
    task assigned one visible card gets it as the current device, with
    ``CUDA_VISIBLE_DEVICES`` left as it was; any other assignment
    raises."""
    from mlcomp_tpu_torch.worker.tasks import ExecuteBuilder
    if visible is None:
        monkeypatch.delenv('CUDA_VISIBLE_DEVICES', raising=False)
    else:
        monkeypatch.setenv('CUDA_VISIBLE_DEVICES', visible)
    calls = []
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'set_device', calls.append)
    config, folder = _mlp_config(tmp_path)
    task_id = _run_failing(port_session, config, folder,
                           cores_assigned=json.dumps(cores))
    builder = ExecuteBuilder(task_id, session=port_session)
    builder.create_base()
    if device is None:
        with pytest.raises(RuntimeError, match='already initialised'):
            builder.pin_cores()
        assert calls == []
    else:
        builder.pin_cores()
        assert calls == [device]
    assert os.environ.get('CUDA_VISIBLE_DEVICES') == visible


def test_download_materializes_the_stored_code(tmp_path, port_session,
                                               monkeypatch):
    from mlcomp_tpu_torch.worker import storage
    for name in ('TASK_FOLDER', 'DATA_FOLDER', 'MODEL_FOLDER'):
        monkeypatch.setattr(storage, name, str(tmp_path / name.lower()))
    source = open(os.path.join(HIER, 'executors.py')).read()
    config = yaml.safe_load(open(os.path.join(HIER, 'config.yml')))
    folder = _twin(tmp_path, 'port', source, config)
    _, tasks = dag_standard(port_session, config, upload_folder=str(folder))
    (task_id,) = tasks['demo']
    assert execute_by_id(task_id, session=port_session) == 'success'
    task_dir = tmp_path / 'task_folder' / str(task_id)
    assert (task_dir / 'executors.py').read_text() == \
        (folder / 'executors.py').read_text()
    assert os.readlink(task_dir / 'data') == str(
        tmp_path / 'data_folder' / 'examples')


def test_a_folder_importing_the_jax_package_fails_with_its_error(
        tmp_path, port_session):
    """The JAX package's executor class registers in the JAX registry,
    not the port's: the port does not run it (on the card the import of
    ``mlcomp_tpu`` itself fails, for want of jax)."""
    from mlcomp_tpu_torch.worker.storage import Storage
    folder = tmp_path / 'jax_code'
    folder.mkdir()
    (folder / 'executors.py').write_text(open(os.path.join(
        HIER, 'executors.py')).read().replace('StepTreeDemo',
                                              'JaxOnlyDemo'))
    with pytest.raises(ModuleNotFoundError, match='jax_only_demo'):
        Storage(port_session).import_executor(str(folder), 'jax_only_demo')
    assert not Executor.is_registered('jax_only_demo')


def test_jax_train_is_the_ports_train():
    from mlcomp_tpu_torch.train.executor import Train
    assert Executor.get('jax_train') is Train
    assert Executor.get('JaxTrain') is Train


def test_wait_sync_passes_on_one_computer_and_refuses_others(
        tmp_path, port_session, monkeypatch):
    """The barrier passes at once on one computer; a task of the project
    that ran on another computer holds it (600 polls a second apart, as
    the JAX barrier's, then ``TimeoutError``; the sleeps are recorded,
    not slept) until FileSync marks it synced."""
    import time
    from mlcomp_tpu_torch.db.models import Task
    from mlcomp_tpu_torch.db.providers import TaskSyncedProvider
    from mlcomp_tpu_torch.utils.misc import hostname
    config = {'info': {'name': 'w', 'project': 'w'},
              'executors': {'v': {'type': 'valid_classify', 'y': '1',
                                  'wait_sync': True}}}
    dag, tasks = dag_standard(port_session, config)
    ex = Executor.from_config('v', config)
    ex.session, ex.dag = port_session, dag
    ex.wait_data_sync()                     # nothing ran elsewhere
    elsewhere = Task(name='elsewhere', executor='v', dag=dag.id,
                     status=int(TaskStatus.Success),
                     computer_assigned='other-host')
    port_session.add(elsewhere)
    sleeps = []
    monkeypatch.setattr(time, 'sleep', sleeps.append)
    with pytest.raises(TimeoutError, match='data sync barrier'):
        ex.wait_data_sync()
    assert sleeps == [1] * 600
    TaskSyncedProvider(port_session).mark_synced(hostname(), elsewhere.id)
    ex.wait_data_sync()


@pytest.mark.parametrize('exc', [
    ValueError('x'), RuntimeError('CUDA error: out of memory'),
    MemoryError(), sqlite3.OperationalError('database is locked'),
    FileNotFoundError('f'), ConnectionResetError('reset'),
    TimeoutError('t'), RuntimeError('NCCL collective timed out')])
def test_failures_classify_as_jax_classifies_them(exc):
    from mlcomp_tpu.recovery import classify_exception as jax_classify
    from mlcomp_tpu_torch.recovery import classify_exception
    assert classify_exception(exc) == jax_classify(exc)

"""The model registry and pipes of the port against the JAX package's:
``dag_model_add``, ``ModelAdd``, ``dag_pipe``, ``dag_model_start``,
``ModelProvider.model_start_begin``, the three ``/api/model/*`` routes,
``dag`` on a ``pipes:`` config and the Equation's ``model_id`` lookup.

A small MLP is trained once, on the CPU, through the port's task
pipeline (``dag_standard`` + ``execute_by_id``); each test copies that
DB into a twin pair (the schema is one), and the same call goes to each
package's function on its copy. Rows and the DAG configs they store are
held equal exactly (datetimes and the random trace ids aside), exports
leaf for leaf and bit for bit. JAX's trainer is never run here: it is
the port's checkpoint that both packages register.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

import mlcomp_tpu
import mlcomp_tpu.server.api as jax_api
from mlcomp_tpu.__main__ import main as jax_cli
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.providers import ModelProvider as JaxModels
from mlcomp_tpu.server.create_dags import dag_model_add as jax_model_add
from mlcomp_tpu.server.create_dags import dag_model_start as jax_model_start
from mlcomp_tpu.server.create_dags import dag_pipe as jax_dag_pipe
from mlcomp_tpu.train.export import make_predictor as jax_make_predictor
from mlcomp_tpu.utils.io import yaml_load as jax_yaml_load
from mlcomp_tpu.worker.executors import Executor as JaxExecutor
import mlcomp_tpu_torch
import mlcomp_tpu_torch.server.api as api
from mlcomp_tpu_torch.__main__ import main as port_cli
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import DagType, TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.providers import (
    ModelProvider, ProjectProvider, TaskProvider,
)
from mlcomp_tpu_torch.server.create_dags import (
    dag_model_add, dag_model_start, dag_pipe, dag_standard,
)
from mlcomp_tpu_torch.utils.csv_io import read_csv
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.misc import now
from mlcomp_tpu_torch.utils.msgpack_io import msgpack_restore
from mlcomp_tpu_torch.worker import storage
from mlcomp_tpu_torch.worker.executors import Executor
from mlcomp_tpu_torch.worker.tasks import execute_by_id

from tests.test_torch_port_api import _request, normalise

PROJECT = 'p_pipes'
DATASET = {'name': 'synthetic_images', 'n_train': 256, 'n_valid': 64,
           'image_size': 8, 'channels': 1, 'num_classes': 4}
TRAIN_CONFIG = {
    'info': {'name': 'train_dag', 'project': PROJECT},
    'executors': {'train': {
        'type': 'train', 'device': 'cpu',
        'model': {'name': 'mlp', 'num_classes': 4, 'hidden': [32],
                  'dtype': 'float32'},
        'dataset': DATASET, 'batch_size': 64,
        'stages': [{'name': 's1', 'epochs': 2,
                    'optimizer': {'name': 'adam', 'lr': 3e-3}}]}},
}
PIPE = {
    'infer': {'type': 'infer_classify', 'dataset': DATASET,
              'batch_size': 64, 'device': 'cpu'},
    'valid': {'type': 'valid_classify', 'dataset': DATASET,
              'depends': 'infer', 'device': 'cpu'},
    'submit': {'type': 'submit_classify', 'dataset': DATASET,
               'depends': 'infer'},
}
PIPE_CONFIG = {'info': {'name': 'serve_pipe', 'project': PROJECT},
               'pipes': {'serve_pipe': PIPE}}
#: a version for each overlay rule: per key on a multi-executor pipe, and
#: a second version chosen over the first
VERSIONS = [
    {'name': 'v1', 'equations': {'infer': {'batch_size': 32}}},
    {'name': 'v2', 'equations': {'infer': {'batch_size': 16},
                                 'valid': {'metric': 'f1_macro'},
                                 'absent': {'x': 1}}},
]


def _untimed(obj):
    return normalise(obj)


def _copy_db(src, dst):
    for suffix in ('', '-wal', '-shm'):
        if os.path.exists(str(dst) + suffix):
            os.remove(str(dst) + suffix)
    shutil.copy(src, dst)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The port's DB after the MLP's train task ran (its checkpoint
    under ``tasks/``), and the task's id."""
    folder = tmp_path_factory.mktemp('registry')
    path = folder / 'template.db'
    with pytest.MonkeyPatch.context() as mp:
        _folders(mp, folder)
        session = Session.create_session(
            key='registry-template', connection_string=f'sqlite:///{path}')
        migrate(session)
        _, tasks = dag_standard(session, TRAIN_CONFIG)
        (tid,) = tasks['train']
        assert execute_by_id(tid, session=session) == 'success'
        Session.cleanup('registry-template')
    return {'db': path, 'folder': folder, 'task': tid}


def _folders(mp, folder):
    """Both packages' task, data and model folders under ``folder``: the
    task folder shared (the checkpoint both register), the model folders
    apart (each package's export)."""
    for name, sub in (('TASK_FOLDER', 'tasks'), ('DATA_FOLDER', 'data'),
                      ('MODEL_FOLDER', 'models')):
        mp.setattr(mlcomp_tpu_torch, name, str(folder / sub))
        mp.setattr(storage, name, str(folder / sub))
        mp.setattr(mlcomp_tpu, name, str(folder / (
            sub if sub == 'tasks' else 'jax_' + sub)))


class Twin:
    """JAX's session and the port's, each on a copy of the template."""

    def __init__(self, tmp_path, monkeypatch, trained):
        self.tmp_path = tmp_path
        self.folder = trained['folder']
        self.task = trained['task']
        _folders(monkeypatch, self.folder)
        for name in ('jax', 'port'):
            _copy_db(trained['db'], tmp_path / f'{name}.db')
        self.jax_cs = f'sqlite:///{tmp_path}/jax.db'
        self.port_cs = f'sqlite:///{tmp_path}/port.db'
        monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', self.jax_cs)
        monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                            self.port_cs)
        self.jax = JaxSession.create_session(
            key=f'registry-jax-{tmp_path}', connection_string=self.jax_cs)
        self.port = Session.create_session(
            key=f'registry-port-{tmp_path}', connection_string=self.port_cs)

    def resync(self):
        """JAX's twin made a copy of the port's DB again."""
        JaxSession.cleanup(self.jax.key)
        Session.cleanup(self.port.key)
        _copy_db(self.tmp_path / 'port.db', self.tmp_path / 'jax.db')
        self.jax = JaxSession.create_session(key=self.jax.key,
                                             connection_string=self.jax_cs)
        self.port = Session.create_session(key=self.port.key,
                                           connection_string=self.port_cs)

    def rows(self, table, where='1=1', params=(), session=None):
        return [dict(r) for r in (session or self.port).query(
            f'SELECT * FROM {table} WHERE {where} ORDER BY id', params)]

    def both_rows(self, table, where='1=1', params=()):
        """The rows of ``table`` in each DB, datetimes normalised and the
        YAML of a dag's config and a model's equations parsed (PyYAML
        writes an anchor for a dict a config holds twice, and folds long
        quoted strings; the port's writer does neither); the port's once
        they are equal."""
        out = []
        for session, load in ((self.port, yaml_load),
                              (self.jax, jax_yaml_load)):
            rows = self.rows(table, where, params, session)
            column = {'dag': 'config', 'model': 'equations'}.get(table)
            for r in rows if column else ():
                r[column] = load(r[column]) if r[column] else r[column]
            out.append(_untimed(rows))
        assert out[0] == out[1], table
        return out[0]

    def close(self):
        JaxSession.cleanup(self.jax.key)
        Session.cleanup(self.port.key)


@pytest.fixture()
def twin(tmp_path, monkeypatch, trained):
    t = Twin(tmp_path, monkeypatch, trained)
    yield t
    t.close()


def _config(session, dag_id) -> dict:
    return yaml_load(session.query_one('SELECT config FROM dag WHERE id=?',
                                       (dag_id,))['config'])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _export_leaves(base: str) -> dict:
    with open(base + '.msgpack', 'rb') as fh:
        return dict(_leaves(msgpack_restore(fh.read())))


# ------------------------------------------------------------- model_add
def test_model_add_without_a_task_writes_the_row_alone(twin):
    project = ProjectProvider(twin.port).by_name(PROJECT).id
    data = {'name': 'bare_model', 'project': project, 'equations': ''}
    assert dag_model_add(twin.port, data) is None
    assert jax_model_add(twin.jax, dict(data)) is None
    (row,) = twin.both_rows('model')
    assert (row['name'], row['project'], row['dag']) == \
        ('bare_model', project, None)
    twin.both_rows('dag')


def test_model_add_dag_is_jaxs(twin):
    data = {'name': 'prod_model', 'task': twin.task}
    dag = dag_model_add(twin.port, data)
    want = jax_model_add(twin.jax, dict(data))
    assert dag.id == want.id
    config = _config(twin.port, dag.id)
    assert config == jax_yaml_load(twin.jax.query_one(
        'SELECT config FROM dag WHERE id=?', (want.id,))['config'])
    spec = config['executors']['model_add']
    assert (spec['task'], spec['name'], spec['file']) == \
        (twin.task, 'prod_model', None)
    twin.both_rows('dag')
    tasks = twin.both_rows('task', 'dag=?', (dag.id,))
    assert [t['executor'] for t in tasks] == ['model_add']


def test_model_add_executor_exports_and_writes_the_row_as_jax(twin):
    """The port's ModelAdd task (through ``execute_by_id``) and JAX's
    executor on the twin: the same Model row, export leaves bit for bit
    equal, the same sidecar; a second registration updates the row."""
    dag = dag_model_add(twin.port, {'name': 'prod_model',
                                    'task': twin.task})
    (tid,) = [t['id'] for t in twin.rows('task', 'dag=?', (dag.id,))]
    assert execute_by_id(tid, session=twin.port) == 'success'
    jax_model_add(twin.jax, {'name': 'prod_model', 'task': twin.task})
    config = jax_yaml_load(twin.jax.query_one(
        'SELECT config FROM dag WHERE id=?', (dag.id,))['config'])
    ex = JaxExecutor.from_config('model_add', config, session=twin.jax)
    ex.step = None
    jax_result = ex.work()
    result = yaml_load(TaskProvider(twin.port).by_id(tid).result)
    assert result == jax_result
    (row,) = twin.both_rows('model')
    train = TaskProvider(twin.port).by_id(twin.task)
    assert (row['name'], row['score_local'], row['dag']) == \
        ('prod_model', train.score, train.dag)
    mine = os.path.join(mlcomp_tpu_torch.MODEL_FOLDER, PROJECT, 'prod_model')
    theirs = os.path.join(mlcomp_tpu.MODEL_FOLDER, PROJECT, 'prod_model')
    got, want = _export_leaves(mine), _export_leaves(theirs)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key
    with open(mine + '.json') as a, open(theirs + '.json') as b:
        assert json.load(a) == json.load(b)
    # the best checkpoint's params, leaf for leaf
    ck = os.path.join(mlcomp_tpu_torch.TASK_FOLDER, str(twin.task),
                      'checkpoints', 'best.msgpack')
    with open(ck, 'rb') as fh:
        params = dict(_leaves(msgpack_restore(fh.read())['params']))
    assert {('params',) + k: v.tobytes() for k, v in params.items()} == \
        {k: v.tobytes() for k, v in got.items()}

    # registering again updates the row, in both packages
    for models in (ModelProvider(twin.port), JaxModels(twin.jax)):
        m = models.by_name('prod_model')
        m.score_local = 0.25
        models.update(m)
    again = Executor.from_config('model_add', _config(twin.port, dag.id),
                                 session=twin.port)
    again.step = None
    assert again.work() == ex.work() == {'model': row['id']}
    (row,) = twin.both_rows('model')
    assert row['score_local'] == train.score


def test_model_add_exports_a_grid_cells_model(twin):
    """A grid whose cells change the model: the port's ModelAdd exports
    the cell's spec (the model the task trained, which loads), JAX's the
    executor's base spec (a fault of the reference); the leaves are the
    same checkpoint's."""
    from mlcomp_tpu_torch.train.export import load_export_meta, \
        make_predictor
    config = json.loads(json.dumps(TRAIN_CONFIG))
    config['executors']['train']['grid'] = [{'model/hidden': [[16], [24]]}]
    _, tasks = dag_standard(twin.port, config)
    cell = tasks['train'][1]
    assert execute_by_id(cell, session=twin.port) == 'success'
    twin.resync()
    spec = {'info': {'project': PROJECT}, 'executors': {'model_add': {
        'type': 'model_add', 'name': 'cell', 'task': cell,
        'project': ProjectProvider(twin.port).by_name(PROJECT).id}}}
    for registry, session in ((Executor, twin.port),
                              (JaxExecutor, twin.jax)):
        ex = registry.from_config('model_add', spec, session=session)
        ex.step = None
        ex.work()
    mine = os.path.join(mlcomp_tpu_torch.MODEL_FOLDER, PROJECT, 'cell')
    theirs = os.path.join(mlcomp_tpu.MODEL_FOLDER, PROJECT, 'cell')
    assert load_export_meta(mine)['model']['hidden'] == [24]
    assert load_export_meta(theirs)['model']['hidden'] == [32]   # base
    got, want = _export_leaves(mine), _export_leaves(theirs)
    assert {k: v.tobytes() for k, v in got.items()} == \
        {k: v.tobytes() for k, v in want.items()}
    x = np.zeros((3, 8, 8, 1), np.float32)
    assert make_predictor(file=mine, device='cpu')(x).shape == (3, 4)
    twin.both_rows('model')


@pytest.mark.parametrize('missing', ['task', 'checkpoint', 'spec'])
def test_model_add_refuses_as_jax(twin, missing):
    """A task that does not exist, a task without a checkpoint, a DAG
    config without a model spec: the same exception in both."""
    config = {'info': {'project': PROJECT}, 'executors': {'model_add': {
        'type': 'model_add', 'name': 'm', 'task': twin.task}}}
    if missing == 'task':
        config['executors']['model_add']['task'] = 999
    elif missing == 'checkpoint':
        # a second train task that never ran, in both twins
        _, tasks = dag_standard(twin.port, TRAIN_CONFIG)
        config['executors']['model_add']['task'] = tasks['train'][0]
        twin.resync()
    else:
        for session in (twin.port, twin.jax):
            session.execute(
                'UPDATE dag SET config=? WHERE id=(SELECT dag FROM task '
                'WHERE id=?)', (yaml_dump({'executors': {'train': {}}}),
                                twin.task))
    errors = []
    for registry, session in ((Executor, twin.port),
                              (JaxExecutor, twin.jax)):
        ex = registry.from_config('model_add', config, session=session)
        ex.step = None
        with pytest.raises(Exception) as info:
            ex.work()
        errors.append((type(info.value).__name__,
                       str(info.value).replace(
                           str(mlcomp_tpu.MODEL_FOLDER), '<models>')))
    assert errors[0] == errors[1]
    assert twin.rows('model') == []


# ------------------------------------------------------------------ pipes
def test_pipe_registration_and_repointing_are_jaxs(twin):
    text = yaml_dump(PIPE_CONFIG)
    first = dag_pipe(twin.port, PIPE_CONFIG, config_text=text)
    jax_first = jax_dag_pipe(twin.jax, PIPE_CONFIG, config_text=text)
    assert first.id == jax_first.id and first.type == int(DagType.Pipe)
    project = ProjectProvider(twin.port).by_name(PROJECT).id
    for session in (twin.port, twin.jax):
        for name in ('serve_pipe', 'other'):
            session.execute(
                'INSERT INTO model (name, project, dag, created) VALUES '
                '(?, ?, ?, ?)', (name, project, first.id, str(now())))
    # without config_text: the dict dumped; a second registration
    # re-points the models named after its pipes and its dag
    second = dag_pipe(twin.port, PIPE_CONFIG)
    jax_dag_pipe(twin.jax, PIPE_CONFIG)
    dags = twin.both_rows('dag')
    assert [d['type'] for d in dags] == [int(DagType.Standard)] + \
        [int(DagType.Pipe)] * 2
    assert dags[-1]['config'] == PIPE_CONFIG
    models = twin.both_rows('model')
    assert {m['name']: m['dag'] for m in models} == \
        {'serve_pipe': second.id, 'other': first.id}
    assert twin.rows('task', 'dag=?', (second.id,)) == []


def test_a_new_project_is_made_as_jax(twin):
    config = {'info': {'name': 'p', 'project': 'fresh_project'},
              'pipes': {'x': {'a': {'type': 'equation'}}}}
    dag_pipe(twin.port, config)
    jax_dag_pipe(twin.jax, config)
    twin.both_rows('project')
    twin.both_rows('dag')


# ----------------------------------------------------------- model_start
def _registered(twin, name='prod_model'):
    """A Model row for the trained task in both twins, and the pipe
    registered in both."""
    project = ProjectProvider(twin.port).by_name(PROJECT).id
    for session in (twin.port, twin.jax):
        session.execute(
            'INSERT INTO model (name, project, score_local, equations, '
            'created) VALUES (?, ?, ?, ?, ?)',
            (name, project, 0.5, '', str(now())))
    text = yaml_dump(PIPE_CONFIG)
    pipe = dag_pipe(twin.port, PIPE_CONFIG, config_text=text)
    jax_dag_pipe(twin.jax, PIPE_CONFIG, config_text=text)
    model = ModelProvider(twin.port).by_name(name)
    return model, pipe


@pytest.mark.parametrize('choice', ['none', 'first', 'second', 'string',
                                    'single'])
def test_model_start_is_jaxs(twin, choice):
    """The DAG ``dag_model_start`` submits (its parsed config, tasks and
    dependencies), the version overlay, ``model.equations`` (the
    ``used`` stamp normalised) and ``model.dag``, against JAX's."""
    model, pipe = _registered(twin)
    info = {'name': 'serve_pipe', 'versions': []}
    if choice == 'single':
        config = {'info': {'name': 'one', 'project': PROJECT},
                  'pipes': {'one': {'infer': PIPE['infer']}}}
        pipe = dag_pipe(twin.port, config)
        jax_dag_pipe(twin.jax, config)
        info = {'name': 'one', 'versions': [
            {'name': 'v1', 'equations': {'batch_size': 8}}]}
    elif choice != 'none':
        versions = [dict(v) for v in VERSIONS]
        if choice == 'string':
            versions = [{'name': 'v1', 'equations': yaml_dump(
                VERSIONS[1]['equations'])}]
        info = {'name': 'serve_pipe', 'versions': versions}
        if choice == 'second':
            info['version'] = versions[1]
    data = {'model_id': model.id, 'dag': pipe.id, 'pipe': info}
    dag = dag_model_start(twin.port, json.loads(json.dumps(data)))
    want = jax_model_start(twin.jax, json.loads(json.dumps(data)))
    assert dag.id == want.id
    config = _config(twin.port, dag.id)
    assert config == jax_yaml_load(twin.jax.query_one(
        'SELECT config FROM dag WHERE id=?', (want.id,))['config'])
    for spec in config['executors'].values():
        assert (spec['model_id'], spec['model_name']) == \
            (model.id, 'prod_model')
    batch = {'none': 64, 'first': 32, 'second': 16, 'string': 16,
             'single': 8}[choice]
    assert config['executors']['infer']['batch_size'] == batch
    twin.both_rows('dag')
    twin.both_rows('task', 'dag=?', (dag.id,))
    twin.both_rows('task_dependence')
    (row,) = twin.both_rows('model')
    assert row['dag'] == pipe.id
    used = [v['name'] for v in row['equations'][info['name']]
            if v.get('used')]
    assert used == ({'none': [], 'first': ['v1'], 'second': ['v2'],
                     'string': ['v1'], 'single': ['v1']}[choice])


@pytest.mark.parametrize('bad', ['model', 'dag', 'pipe'])
def test_model_start_refuses_as_jax(twin, bad):
    model, pipe = _registered(twin)
    data = {'model_id': model.id, 'dag': pipe.id,
            'pipe': {'name': 'serve_pipe'}}
    if bad == 'model':
        data['model_id'] = 99
    elif bad == 'dag':
        data['dag'] = 99
    else:
        data['pipe']['name'] = 'absent'
    with pytest.raises(ValueError) as mine:
        dag_model_start(twin.port, dict(data))
    with pytest.raises(ValueError) as theirs:
        jax_model_start(twin.jax, dict(data))
    assert str(mine.value) == str(theirs.value)


def test_model_start_begin_is_jaxs(twin):
    model, pipe = _registered(twin)
    dag_model_start(twin.port, {'model_id': model.id, 'dag': pipe.id,
                                'pipe': {'name': 'serve_pipe',
                                         'versions': VERSIONS}})
    jax_model_start(twin.jax, {'model_id': model.id, 'dag': pipe.id,
                               'pipe': {'name': 'serve_pipe',
                                        'versions': VERSIONS}})
    for model_id in (model.id, 99):
        got = ModelProvider(twin.port).model_start_begin(model_id)
        want = JaxModels(twin.jax).model_start_begin(model_id)
        assert _untimed(got) == _untimed(want)
    assert got == {}
    got = ModelProvider(twin.port).model_start_begin(model.id)
    assert got['pipes'] == [{'name': 'serve_pipe'}]
    assert [v['name'] for v in got['versions']] == ['serve_pipe']


# -------------------------------------------------------- the lifecycle
def test_the_port_lifecycle_runs_infer_valid_and_submit(twin):
    """``tests/test_pipes.py``'s lifecycle through the port on the CPU:
    the model registered from its train task, the pipe registered and
    started for it with a version, its tasks run by ``execute_by_id``.
    The predictions equal JAX's predictor on the registered export
    (1e-6), the valid score is their accuracy and the model's
    ``score_local``, and the submission holds their argmax."""
    from mlcomp_tpu_torch.train.data import create_dataset
    provider = TaskProvider(twin.port)
    add = dag_model_add(twin.port, {'name': 'prod_model',
                                    'task': twin.task})
    for t in provider.by_dag(add.id):
        assert execute_by_id(t.id, session=twin.port) == 'success'
    model = ModelProvider(twin.port).by_name('prod_model')
    pipe = dag_pipe(twin.port, PIPE_CONFIG)
    assert provider.by_dag(pipe.id) == []
    run = dag_model_start(twin.port, {
        'model_id': model.id, 'dag': pipe.id,
        'pipe': {'name': 'serve_pipe', 'versions': VERSIONS[:1]}})
    tasks = sorted(provider.by_dag(run.id), key=lambda t: t.id)
    assert [t.executor for t in tasks] == ['infer', 'valid', 'submit']
    for t in tasks:
        assert execute_by_id(t.id, session=twin.port) == 'success'
    tasks = {t.executor: t for t in provider.by_dag(run.id)}
    assert all(t.status == int(TaskStatus.Success) for t in tasks.values())
    data = os.path.join(mlcomp_tpu_torch.DATA_FOLDER, PROJECT)
    preds = np.load(os.path.join(data, 'pred', 'prod_model.npy'))
    x = create_dataset(**DATASET)['x_valid']
    y = create_dataset(**DATASET)['y_valid']
    export = os.path.join(mlcomp_tpu_torch.MODEL_FOLDER, PROJECT,
                          'prod_model')
    want = jax_make_predictor(file=export, batch_size=32,
                              activation='softmax')(x)
    np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)
    accuracy = float((preds.argmax(-1) == y).mean())
    model = ModelProvider(twin.port).by_name('prod_model')
    assert tasks['valid'].score == accuracy == model.score_local
    sub = read_csv(os.path.join(data, 'submissions', 'submission.csv'))
    assert list(sub) == ['id', 'label']
    np.testing.assert_array_equal(sub['id'], np.arange(len(x)))
    np.testing.assert_array_equal(sub['label'], preds.argmax(-1))
    assert yaml_load(model.equations)['serve_pipe'][0]['used']


def test_equations_name_the_model_by_its_registry_id(twin, tmp_path,
                                                     monkeypatch):
    """An Equation with ``model_id`` and a session reads the registry
    name (JAX's ``_resolve_model_name``): ``load()`` finds its
    predictions, and a Valid writes ``score_local`` through the id."""
    model, _ = _registered(twin, name='by_id')
    monkeypatch.chdir(tmp_path)
    os.makedirs(os.path.join('data', 'pred'))
    preds = np.eye(4, dtype=np.float32)[np.arange(8) % 4]
    np.save(os.path.join('data', 'pred', 'by_id.npy'), preds)
    for registry, session in ((Executor, twin.port),
                              (JaxExecutor, twin.jax)):
        ex = registry.get('valid_classify')(model_id=model.id,
                                            dataset=DATASET)
        ex.session = session
        assert ex._resolve_model_name() == 'by_id' and ex.name == 'by_id'
        np.testing.assert_array_equal(ex.load(), preds)
        ex._write_scores(0.75)
    twin.both_rows('model')
    assert ModelProvider(twin.port).by_id(model.id).score_local == 0.75


# ------------------------------------------------------------ the routes
@pytest.fixture(scope='module')
def servers():
    pair = (jax_api.ApiServer(host='127.0.0.1', port=0).start_background(),
            api.ApiServer(host='127.0.0.1', port=0).start_background())
    yield pair
    for server in pair:
        server.shutdown()


def test_model_routes_answer_as_jax(twin, servers):
    """``/api/model/add`` (with and without a task), ``start_begin`` and
    ``start_end``: the same status and JSON from both servers, and the
    same rows behind them; no route of the registry waits."""
    jax_server, port_server = servers
    sessions = (JaxSession.create_session(key=jax_api._SESSION_KEY,
                                          connection_string=twin.jax_cs),
                Session.create_session(key=api._SESSION_KEY,
                                       connection_string=twin.port_cs))
    try:
        text = yaml_dump(PIPE_CONFIG)
        pipe = dag_pipe(twin.port, PIPE_CONFIG, config_text=text)
        jax_dag_pipe(twin.jax, PIPE_CONFIG, config_text=text)
        project = ProjectProvider(twin.port).by_name(PROJECT).id

        def call(path, data):
            mine = _request(f'http://127.0.0.1:{port_server.port}', path,
                            data)
            theirs = _request(f'http://127.0.0.1:{jax_server.port}', path,
                              data)
            assert mine[0] == theirs[0] == 200, (path, mine, theirs)
            assert normalise(mine[1]) == normalise(theirs[1]), path
            return mine[1]

        assert call('/api/model/add', {'name': 'bare', 'project': project}
                    ) == {'success': True, 'dag': None}
        added = call('/api/model/add', {'name': 'prod_model',
                                        'task': twin.task})
        assert added['dag']
        twin.both_rows('task', 'dag=?', (added['dag'],))
        model = ModelProvider(twin.port).by_name('bare')
        begin = call('/api/model/start_begin', {'model_id': model.id})
        assert begin['pipes'] == [{'name': 'serve_pipe'}]
        started = call('/api/model/start_end', {
            'model_id': model.id, 'dag': pipe.id,
            'pipe': {'name': 'serve_pipe', 'versions': VERSIONS}})
        assert started['success'] and started['dag']
        for table in ('dag', 'task', 'model', 'task_dependence'):
            twin.both_rows(table)
        assert call('/api/model/start_begin', {'model_id': 99}) == {}
    finally:
        JaxSession.cleanup(jax_api._SESSION_KEY)
        Session.cleanup(api._SESSION_KEY)
    assert sorted(api.WAITING_ROUTES) == [
        '/api/db', '/api/db_audit', '/api/worker_token']
    for route in ('/api/model/add', '/api/model/start_begin',
                  '/api/model/start_end'):
        assert api._ROUTES[route][0].__name__ == \
            jax_api._ROUTES[route][0].__name__


def test_dag_registers_a_pipes_config_as_jax(twin, tmp_path):
    """``dag CONFIG`` on a ``pipes:`` config: a Pipe row, no tasks, the
    same line and rows as JAX's command (each on its twin DB)."""
    folder = tmp_path / 'pipe_folder'
    folder.mkdir()
    path = folder / 'config.yml'
    path.write_text(yaml_dump(PIPE_CONFIG))
    Session.cleanup('default')
    JaxSession.cleanup('default')
    try:
        result = CliRunner().invoke(jax_cli, ['dag', str(path)])
        assert result.exit_code == 0, result.output
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert port_cli(['dag', str(path)]) in (0, None)
    finally:
        Session.cleanup('default')
        JaxSession.cleanup('default')
    assert out.getvalue().splitlines()[-1] == \
        result.output.splitlines()[-1]
    dags = twin.both_rows('dag')
    assert dags[-1]['type'] == int(DagType.Pipe)
    assert dags[-1]['config'] == PIPE_CONFIG
    assert twin.rows('task', 'dag=?', (dags[-1]['id'],)) == []
    twin.both_rows('dag_storage')

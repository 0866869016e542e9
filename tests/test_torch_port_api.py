"""The port's JSON API and dashboard against the JAX package's, on twin
sqlite DBs (the pattern of ``tests/test_torch_port_supervisor.py``): the
same DAG goes in through each package's ``dag_standard``, the same
requests go to JAX's ``ApiServer`` and to the port's, both on port 0,
and the JSON that comes back must be equal after normalisation.

Normalisation: a datetime string becomes ``<time>``, a 32-digit hex
string of 16 or 32 hex digits (a trace id) ``<hex>``; a DAG's task rows carry the same ids in
both DBs (both start from the same migrations), so ids stay as they
are. Errors compare by status code (a traceback names its package's
files).

Also here: the telemetry routes (``/api/task/devtime``,
``/api/task/postmortem`` and their GET mirrors, ``/api/telemetry/profile``)
against JAX's on twin rows, every route that waits for an unported
module refuses with 501 and its ROADMAP.md item, the dashboard page
against JAX's (one
listed difference) with every ``api('...')`` call routed, ``GET
/metrics`` parsed from both (equal but the families listed as waiting),
the port's restart-with-resume of a real training task on the CPU,
the heal-and-retry rule (reads only), ``/api/stop`` and ``server stop``
over a faked process table, and ``start-site`` in a subprocess with
click, psutil, PyYAML and JAX unimportable."""

import io
import json
import os
import re
import signal
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile

import pytest

import mlcomp_tpu
import mlcomp_tpu.server.api as jax_api
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.db.models import ReportImg as JaxReportImg
from mlcomp_tpu.db.models import Task as JaxTask
from mlcomp_tpu.db.providers import ReportImgProvider as JaxImgs
from mlcomp_tpu.db.providers import TaskProvider as JaxTasks
from mlcomp_tpu.server.create_dags.standard import (
    dag_standard as jax_dag_standard,
)
from mlcomp_tpu.server.front import dashboard_html as jax_dashboard_html
from mlcomp_tpu.telemetry.export import (
    parse_openmetrics as jax_parse_openmetrics,
)
from mlcomp_tpu.utils.misc import now
from mlcomp_tpu_torch import TOKEN
import mlcomp_tpu_torch.server.api as api
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import ReportImg, Task
from mlcomp_tpu_torch.db.providers import ReportImgProvider, TaskProvider
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.server.front import dashboard_html
from mlcomp_tpu_torch.telemetry.export import (
    REQUIRED_FAMILIES, WAITING_FAMILIES, parse_openmetrics,
)
from mlcomp_tpu_torch.utils.io import yaml_load

from tests.test_executors import EXPDIR_CODE, EXPDIR_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the one line where the port's page names its own package
DASHBOARD_DIFFERENCES = [('(mlcomp_tpu/recovery.py)',
                          '(mlcomp_tpu_torch/recovery.py)')]

_TIME = re.compile(r'^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}:\d{2}(\.\d+)?$')
_HEX = re.compile(r'\b[0-9a-f]{16}(?:[0-9a-f]{16})?\b')


def normalise(obj):
    """Datetimes → ``<time>``, trace ids → ``<hex>``, recursively (a
    YAML or JSON blob inside a string included)."""
    if isinstance(obj, dict):
        return {k: normalise(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [normalise(v) for v in obj]
    if isinstance(obj, str):
        if _TIME.match(obj):
            return '<time>'
        obj = re.sub(r'\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}:\d{2}(\.\d+)?',
                     '<time>', obj)
        return _HEX.sub('<hex>', obj)
    return obj


def _request(base, path, data=None, token=TOKEN, method='POST', raw=None):
    """(status, body): the JSON, or the bytes of a file download."""
    url = base + path
    if method == 'GET':
        req = urllib.request.Request(url)
    else:
        body = raw if raw is not None else json.dumps(data or {}).encode()
        req = urllib.request.Request(
            url, data=body, headers={'Content-Type': 'application/json'})
    if token is not None:
        req.add_header('Authorization', token)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, payload, ctype = resp.status, resp.read(), \
                resp.headers.get('Content-Type', '')
    except urllib.error.HTTPError as e:
        status, payload, ctype = e.code, e.read(), \
            e.headers.get('Content-Type', '')
    if 'json' in ctype:
        return status, json.loads(payload)
    return status, payload


def _copy_db(src, dst):
    import shutil
    for suffix in ('-wal', '-shm'):
        if os.path.exists(str(dst) + suffix):
            os.remove(str(dst) + suffix)
    shutil.copy(src, dst)


@pytest.fixture(scope='module')
def templates(tmp_path_factory):
    """Migrated DB files of each package, empty and holding EXPDIR's
    two-task DAG (built through each package's ``dag_standard`` with the
    same code: it is stored and read, never run, here); copied for each
    test, since building the DAG reads every installed distribution."""
    folder = tmp_path_factory.mktemp('api_templates')
    out = {'ids': []}
    config = yaml_load(EXPDIR_CONFIG)
    for name, session_cls, do_migrate, builder in (
            ('jax', JaxSession, jax_migrate, jax_dag_standard),
            ('port', Session, migrate, dag_standard)):
        for kind in ('empty', 'dag'):
            key = f'template-{name}-{kind}'
            path = folder / f'{name}_{kind}.db'
            session = session_cls.create_session(
                key=key, connection_string=f'sqlite:///{path}')
            do_migrate(session)
            if kind == 'dag':
                code = folder / f'{name}_code'
                code.mkdir()
                (code / 'config.yml').write_text(EXPDIR_CONFIG)
                (code / 'executors.py').write_text(EXPDIR_CODE)
                dag, tasks = builder(session, config,
                                     config_text=EXPDIR_CONFIG,
                                     upload_folder=str(code))
                out['ids'].append((dag.id, tasks))
            session_cls.cleanup(key)        # checkpoints the WAL
            out[name, kind] = path
    assert out['ids'][0] == out['ids'][1]
    return out


@pytest.fixture(scope='module')
def servers():
    """One JAX ``ApiServer`` and one of the port's for the module, both
    on port 0; each test points their sessions at its own DB files."""
    pair = (jax_api.ApiServer(host='127.0.0.1', port=0).start_background(),
            api.ApiServer(host='127.0.0.1', port=0).start_background())
    yield pair
    _shutdown(*pair)


def _shutdown(*servers):
    """Shut servers down together (each waits out its 0.5 s poll)."""
    import threading
    threads = [threading.Thread(target=s.shutdown) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)


class Twin:
    """The JAX API and the port's over twin DBs (copies of one
    template)."""

    def __init__(self, tmp_path, monkeypatch, templates, servers):
        self.tmp_path = tmp_path
        self.templates = templates
        self.jax_server, self.port_server = servers
        self.jax_cs = f'sqlite:///{tmp_path}/jax.db'
        self.port_cs = f'sqlite:///{tmp_path}/port.db'
        # JAX's heal path reopens the default DB: make that the twin's
        monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', self.jax_cs)
        self.dag_id = None
        self.tasks = None
        self.load('empty')

    def load(self, kind: str):
        """Both DBs from the ``kind`` template, the API sessions on
        them."""
        self.close()
        _copy_db(self.templates['jax', kind], self.tmp_path / 'jax.db')
        _copy_db(self.templates['port', kind], self.tmp_path / 'port.db')
        self.jax = JaxSession.create_session(
            key=jax_api._SESSION_KEY, connection_string=self.jax_cs)
        self.port = Session.create_session(
            key=api._SESSION_KEY, connection_string=self.port_cs)

    def add_dag(self):
        self.load('dag')
        self.dag_id, self.tasks = self.templates['ids'][0]
        return self.dag_id

    def both_sql(self, sql, params=()):
        self.jax.execute(sql, params)
        self.port.execute(sql, params)

    def call(self, path, data=None, **kw):
        """The same request to both servers: the port's (status, body)
        once both agree."""
        theirs = _request(f'http://127.0.0.1:{self.jax_server.port}',
                          path, data, **kw)
        mine = _request(f'http://127.0.0.1:{self.port_server.port}',
                        path, data, **kw)
        assert mine[0] == theirs[0], (path, mine, theirs)
        if mine[0] == 200 and not isinstance(mine[1], bytes):
            assert normalise(mine[1]) == normalise(theirs[1]), path
        return mine

    def ok(self, path, data=None, **kw):
        status, body = self.call(path, data, **kw)
        assert status == 200, (path, body)
        return body

    def port_call(self, path, data=None, **kw):
        return _request(f'http://127.0.0.1:{self.port_server.port}',
                        path, data, **kw)

    def close(self):
        JaxSession.cleanup(jax_api._SESSION_KEY)
        Session.cleanup(api._SESSION_KEY)


@pytest.fixture()
def twin(tmp_path, monkeypatch, templates, servers):
    t = Twin(tmp_path, monkeypatch, templates, servers)
    yield t
    t.close()


@pytest.fixture()
def dag(twin):
    return twin.add_dag()


# -------------------------------------------------------------------- auth
class TestAuth:
    def test_token_valid_and_invalid(self, twin):
        assert twin.ok('/api/token', {'token': TOKEN})['success']
        assert twin.call('/api/token', {'token': 'wrong'})[0] == 401

    def test_endpoints_require_auth(self, twin):
        assert twin.call('/api/dags', token='bad-token')[0] == 401
        assert twin.call('/api/tasks', token=None)[0] == 401

    def test_auxiliary_is_open(self, twin):
        assert isinstance(twin.ok('/api/auxiliary', token=None), dict)

    def test_unknown_route_404(self, twin):
        assert twin.call('/api/definitely_not_there')[0] == 404
        assert twin.call('/nothing', method='GET')[0] == 404


class TestProjects:
    def test_crud(self, twin):
        twin.ok('/api/project/add', {'name': 'proj_api',
                                     'class_names': ['a', 'b']})
        res = twin.ok('/api/projects')
        pid = next(p['id'] for p in res['data'] if p['name'] == 'proj_api')
        twin.ok('/api/project/edit', {'id': pid, 'name': 'proj_api2'})
        assert 'proj_api2' in [p['name']
                               for p in twin.ok('/api/projects')['data']]
        assert twin.call('/api/project/edit', {'id': 999})[0] == 404
        twin.ok('/api/project/remove', {'id': pid})
        assert 'proj_api2' not in [p['name']
                                   for p in twin.ok('/api/projects')['data']]


class TestDags:
    def test_dags_list_config_graph(self, twin, dag):
        res = twin.ok('/api/dags')
        assert res['data'][0]['task_count'] == 2
        assert 'executors' in twin.ok('/api/config', {'id': dag})['data']
        graph = twin.ok('/api/graph', {'id': dag})
        assert len(graph['nodes']) == 2 and len(graph['edges']) == 1

    def test_code_tree_and_zip(self, twin, dag):
        res = twin.ok('/api/code', {'id': dag})
        assert {'config.yml', 'executors.py'} <= {
            i['name'] for i in res['items']}
        zips = []
        for server in (twin.jax_server, twin.port_server):
            status, raw = _request(f'http://127.0.0.1:{server.port}',
                                   f'/api/code_download?id={dag}',
                                   method='GET')
            assert status == 200
            zf = zipfile.ZipFile(io.BytesIO(raw))
            zips.append({n: zf.read(n) for n in zf.namelist()})
        assert set(zips[0]) == set(zips[1]) == {'config.yml',
                                                'executors.py'}
        assert zips[0]['config.yml'] == zips[1]['config.yml']
        assert b'WriteMarker' in zips[1]['executors.py']
        # the download takes the token from the query too
        assert twin.call(f'/api/code_download?id={dag}&token=bad',
                         method='GET', token=None)[0] == 401

    def test_dag_stop_and_remove(self, twin, dag):
        res = twin.ok('/api/dag/stop', {'id': dag})
        assert {s['name'] for s in res['dag']['task_statuses']
                if s['count']} == {'Stopped'}
        twin.ok('/api/dag/remove', {'id': dag})
        assert dag not in [d['id'] for d in twin.ok('/api/dags')['data']]

    def test_preflight_stored_and_dry_run(self, twin, dag):
        res = twin.ok('/api/dag/preflight', {'id': dag})
        assert res['ok'] is True and res['dag'] == dag
        res = twin.ok('/api/dag/preflight', {
            'config': 'info: {project: p}\nexecutors:\n'
                      '  a: {type: nope, depends: b}\n'})
        assert res['ok'] is False and res['errors']
        assert twin.call('/api/dag/preflight', {'id': 999})[0] == 404
        assert twin.call('/api/dag/preflight', {})[0] == 400


class TestTasks:
    def test_tasks_list_info_steps_logs(self, twin, dag):
        res = twin.ok('/api/tasks')
        assert {t['name'] for t in res['data']} == {'write', 'check'}
        tid = twin.tasks['write'][0]
        assert twin.ok('/api/task/info', {'id': tid})['id'] == tid
        assert twin.ok('/api/task/steps', {'id': tid})['data'] == []
        assert 'total' in twin.ok('/api/logs')

    def test_task_stop(self, twin, dag):
        tid = twin.tasks['write'][0]
        assert twin.ok('/api/task/stop', {'id': tid})['status'] == \
            'stopped'
        assert TaskProvider(twin.port).by_id(tid).status == \
            int(TaskStatus.Stopped)


class TestDagStartResume:
    def test_failed_task_reset_with_resume(self, twin, dag):
        tid = twin.tasks['write'][0]
        twin.both_sql("UPDATE task SET computer_assigned='host_a', "
                      "pid=4242, status=? WHERE id=?",
                      (int(TaskStatus.Failed), tid))
        assert tid in twin.ok('/api/dag/start', {'id': dag})['restarted']
        task = TaskProvider(twin.port).by_id(tid)
        assert task.status == int(TaskStatus.NotRan) and task.pid is None
        assert yaml_load(task.additional_info)['resume'] == {
            'master_computer': 'host_a', 'master_task_id': tid,
            'load_last': True}

    def test_distributed_master_discovery(self, twin, dag):
        tid = twin.tasks['write'][0]
        twin.both_sql('UPDATE task SET status=? WHERE id=?',
                      (int(TaskStatus.Failed), tid))
        for idx, (comp, rank) in enumerate([('host_b', 1), ('host_a', 0)]):
            for provider, model in ((JaxTasks(twin.jax), JaxTask),
                                    (TaskProvider(twin.port), Task)):
                provider.add(model(
                    name=f'svc{idx}', executor='svc', dag=dag, parent=tid,
                    computer_assigned=comp, status=int(TaskStatus.Failed),
                    additional_info=json.dumps(
                        {'distr_info': {'process_index': rank}}),
                    last_activity=now()))
        twin.ok('/api/dag/start', {'id': dag})
        info = yaml_load(TaskProvider(twin.port).by_id(tid).additional_info)
        assert info['resume']['master_computer'] == 'host_a'


def test_killed_training_resumes_from_checkpoint(tmp_path, monkeypatch):
    """The port's end to end on ``device: cpu``: a trained task marked
    Failed, restarted through ``/api/dag/start``, resumes from its
    checkpoint and trains no epoch (JAX's
    ``TestRestartResumeEndToEnd``)."""
    import mlcomp_tpu_torch
    from mlcomp_tpu_torch.worker.tasks import execute_by_id
    monkeypatch.setattr(mlcomp_tpu_torch, 'TASK_FOLDER',
                        str(tmp_path / 'tasks'))
    Session.cleanup(api._SESSION_KEY)
    session = Session.create_session(
        key=api._SESSION_KEY, connection_string=f'sqlite:///{tmp_path}/r.db')
    server = api.start_server(host='127.0.0.1', port=0, background=True,
                              with_supervisor=False,
                              connection_string=session.connection_string)
    try:
        folder = tmp_path / 'exp'
        folder.mkdir()
        config = {
            'info': {'name': 'resume_dag', 'project': 'p_resume'},
            'executors': {'train': {
                'type': 'train', 'device': 'cpu',
                'model': {'name': 'mlp', 'num_classes': 4,
                          'hidden': [16], 'dtype': 'float32'},
                'dataset': {'name': 'synthetic_images', 'n_train': 128,
                            'n_valid': 64, 'image_size': 8, 'channels': 1,
                            'num_classes': 4},
                'batch_size': 32,
                'stages': [{'name': 's1', 'epochs': 1}]}}}
        dag_row, tasks = dag_standard(session, config,
                                      upload_folder=str(folder))
        tid = tasks['train'][0]
        monkeypatch.chdir(folder)
        execute_by_id(tid, folder=str(folder), session=session)
        provider = TaskProvider(session)
        assert provider.by_id(tid).status == int(TaskStatus.Success)
        provider.change_status(provider.by_id(tid), TaskStatus.Failed)
        status, res = _request(f'http://127.0.0.1:{server.port}',
                               '/api/dag/start', {'id': dag_row.id})
        assert status == 200 and tid in res['restarted']
        assert provider.by_id(tid).status == int(TaskStatus.NotRan)
        execute_by_id(tid, folder=str(folder), session=session)
        task = provider.by_id(tid)
        assert task.status == int(TaskStatus.Success)
        result = yaml_load(task.result)
        assert result['samples_per_sec'] == 0   # resumed, not retrained
        assert result['best_score'] is not None
        assert session.query_one(
            "SELECT 1 FROM log WHERE task=? AND message LIKE "
            "'%resumed from checkpoint%'", (tid,)) is not None
    finally:
        server.shutdown()
        Session.cleanup(api._SESSION_KEY)


class TestLayoutsReports:
    def test_layouts_seeded_and_crud(self, twin):
        assert 'base' in [l['name'] for l in twin.ok('/api/layouts')['data']]
        twin.ok('/api/layout/add', {'name': 'mine', 'content': 'layout: []\n'})
        twin.ok('/api/layout/edit', {'name': 'mine',
                                     'content': 'layout: [{type: series}]\n'})
        assert twin.call('/api/layout/add', {'name': 'bad',
                                             'content': 'oops: 1\n'})[0] == 500
        assert twin.call('/api/layout/edit', {'name': 'none',
                                              'content': 'layout: []\n'}
                         )[0] == 404
        twin.ok('/api/layout/remove', {'name': 'mine'})
        assert 'mine' not in [l['name']
                              for l in twin.ok('/api/layouts')['data']]

    def test_report_add_detail_and_toggles(self, twin, dag):
        assert 'base' in twin.ok('/api/report/add_start')['layouts']
        pid = twin.ok('/api/projects')['data'][0]['id']
        twin.ok('/api/report/add_end', {'name': 'rep1', 'project': pid,
                                        'layout': 'base'})
        rid = twin.ok('/api/reports')['data'][0]['id']
        twin.ok('/api/dag/toogle_report', {'id': dag, 'report': rid})
        assert len(twin.ok('/api/report', {'id': rid})['tasks']) == 2
        tid = twin.tasks['write'][0]
        twin.ok('/api/task/toogle_report', {'id': tid, 'report': rid,
                                            'remove': True})
        assert tid not in twin.ok('/api/report', {'id': rid})['tasks']
        twin.ok('/api/dag/toogle_report', {'id': dag, 'report': rid,
                                           'remove': True})
        assert twin.ok('/api/report', {'id': rid})['tasks'] == []

    def test_update_layout(self, twin, dag):
        pid = twin.ok('/api/projects')['data'][0]['id']
        twin.ok('/api/report/add_end', {'name': 'r2', 'project': pid,
                                        'layout': 'classify'})
        rid = twin.ok('/api/reports')['data'][0]['id']
        assert twin.ok('/api/report/update_layout_start',
                       {'id': rid})['current'] == 'classify'
        twin.ok('/api/report/update_layout_end', {'id': rid,
                                                  'layout': 'base'})
        assert twin.ok('/api/report', {'id': rid})['layout'].get('items')
        assert twin.call('/api/report/update_layout_end',
                         {'id': 999, 'layout': 'base'})[0] == 404


class TestGalleries:
    def test_img_classify_segment_and_remove(self, twin, dag):
        tid = twin.tasks['write'][0]
        for provider, model in ((JaxImgs(twin.jax), JaxReportImg),
                                (ReportImgProvider(twin.port), ReportImg)):
            for y, y_pred in [(0, 0), (0, 1), (1, 1)]:
                provider.add(model(group='test', task=tid, dag=dag,
                                   img=b'\x89PNG-fake', y=y, y_pred=y_pred,
                                   part='valid', score=0.5))
        res = twin.ok('/api/img_classify', {'task': tid})
        assert res['total'] == 3 and res['data'][0]['img']
        assert res['confusion']['matrix'] == [[1, 1], [0, 1]]
        assert twin.ok('/api/img_segment', {'task': tid,
                                            'y_pred': 1})['total'] == 2
        twin.ok('/api/remove_imgs', {'task': tid})
        assert twin.ok('/api/img_classify', {'task': tid})['total'] == 0

    def test_remove_files(self, twin, dag):
        twin.ok('/api/remove_files', {'dag': dag})
        assert twin.ok('/api/code', {'id': dag})['items'] == []


class TestComputersModels:
    def test_computers_with_usage_history(self, twin):
        for session in (twin.jax, twin.port):
            session.execute(
                "INSERT INTO computer (name, cores, cpu, memory, ip, "
                "can_process_tasks, usage) VALUES ('h1', 1, 8, 32.0, "
                "'127.0.0.1', 1, ?)", (json.dumps({'cpu': 5}),))
            session.execute(
                "INSERT INTO computer_usage (computer, usage, time) "
                "VALUES ('h1', ?, ?)", (json.dumps({'cpu': 7}), now()))
        res = twin.ok('/api/computers', {'usage_history': True})
        assert res['data'][0]['usage'] == {'cpu': 5}
        assert res['data'][0]['usage_history'][0]['cpu'] == 7

    def test_models_and_remove(self, twin, dag):
        assert twin.ok('/api/models')['total'] == 0
        pid = twin.ok('/api/projects')['data'][0]['id']
        twin.both_sql("INSERT INTO model (name, project, dag, created) "
                      "VALUES ('m1', ?, ?, ?)", (pid, dag, now()))
        assert twin.ok('/api/models')['data'][0]['name'] == 'm1'
        twin.ok('/api/model/remove', {'name': 'm1'})
        assert twin.ok('/api/models')['total'] == 0


class TestTelemetryReads:
    def test_series_spans_trace_alerts(self, twin, dag):
        tid = twin.tasks['write'][0]
        for session in (twin.jax, twin.port):
            session.executemany(
                'INSERT INTO metric (task, name, kind, step, value, time, '
                'component, tags) VALUES (?, ?, ?, ?, ?, ?, ?, ?)',
                [(tid, 'loss', 'gauge', i, 1.0 / (i + 1), now(), 'train',
                  None) for i in range(5)])
            session.execute(
                "INSERT INTO telemetry_span (trace_id, span_id, name, task, "
                "started, duration, process_role) VALUES "
                "('t1', '42.ab-1', 'task.run', ?, 1.0, 2.0, 'worker')",
                (tid,))
            session.execute(
                "INSERT INTO alert (rule, task, severity, status, message, "
                "time, details) VALUES ('stall', ?, 'critical', 'open', "
                "'m', ?, '{\"a\": 1}')", (tid, now()))
        assert len(twin.ok('/api/telemetry/series', {'task': tid})
                   ['series']['loss']) == 5
        assert twin.ok('/api/telemetry/series', {'task': tid, 'tail': 2}
                       )['series']['loss'][-1]['step'] == 4
        assert twin.call('/api/telemetry/series', {'tail': 2})[0] == 400
        assert twin.call('/api/telemetry/series', {'limit': -1})[0] == 400
        assert twin.ok(f'/telemetry/series?task={tid}&name=loss',
                       method='GET', token=None)['series']
        assert twin.ok('/api/telemetry/spans', {'task': tid})['spans']
        assert twin.ok('/telemetry/trace/t1', method='GET',
                       token=None)['span_count'] == 1
        alerts = twin.ok('/api/alerts', token=None)['data']
        assert alerts[0]['details'] == {'a': 1}
        assert twin.ok('/api/alerts?status=all', method='GET',
                       token=None)['data']
        assert twin.call('/api/alerts', {'status': 'bad'})[0] == 400
        assert twin.ok('/api/alert/resolve', {'id': alerts[0]['id']}
                       )['resolved'] is True
        assert twin.ok('/api/alerts')['data'] == []


# --------------------------------------------------------- telemetry routes
def _devtime_rows(tid) -> list:
    """Two sampled windows' ``devtime.*`` rows (steps 10 and 20), as
    ``persist_attribution`` writes them."""
    rows = []
    for step, busy in ((10, 0.5), (20, 0.75)):
        for key in ('compute_ms', 'comm_ms', 'comm_exposed_ms', 'io_ms',
                    'idle_ms', 'busy_frac', 'exposed_comm_frac',
                    'window_ms', 'host_dispatch_gap_ms'):
            rows.append((tid, f'devtime.{key}', 'series', step, busy,
                         now(), 'train', None))
        rows.append((tid, 'devtime.summary', 'gauge', step, 2.0, now(),
                     'train', json.dumps({
                         'buckets': {'compute_ms': 1.0, 'idle_ms': 1.0},
                         'busy_frac': busy, 'device_lines': 1,
                         'host': {'dispatch_count': 3,
                                  'dispatch_gap_ms': 0.25},
                         'ops': [{'op': 'k', 'category': 'compute',
                                  'ms': 1.0, 'count': 3}]})))
    return rows


def _insert_metrics(twin, rows):
    for session in (twin.jax, twin.port):
        session.executemany(
            'INSERT INTO metric (task, name, kind, step, value, time, '
            'component, tags) VALUES (?, ?, ?, ?, ?, ?, ?, ?)', rows)


class TestTelemetryRoutes:
    def test_devtime_and_its_get_mirror(self, twin, dag):
        tid, other = twin.tasks['write'][0], twin.tasks['check'][0]
        _insert_metrics(twin, _devtime_rows(tid))
        body = twin.ok('/api/task/devtime', {'task': tid})
        assert body['windows'] == 2 and body['summary']['step'] == 20
        assert 'devtime.summary' not in body['series']
        assert twin.ok('/api/task/devtime', {'id': tid, 'tail': 1})[
            'windows'] == 1
        status, got = twin.call(f'/api/task/devtime?task={tid}',
                                method='GET', token=None)
        assert status == 200 and got == body
        for data in ({'task': other}, {'task': 999999}):
            assert twin.call('/api/task/devtime', data)[0] == 404
        assert twin.call('/api/task/devtime', {})[0] == 400

    def test_postmortem_live_frozen_and_get_mirror(self, twin, dag):
        from mlcomp_tpu.telemetry.memory import (
            persist_postmortem as jax_persist_postmortem,
        )
        from mlcomp_tpu_torch.telemetry import persist_postmortem
        tid = twin.tasks['write'][0]
        _insert_metrics(twin, _devtime_rows(tid) + [
            (tid, 'loss', 'series', s, 1.0 / (s + 1), now(), 'train', None)
            for s in range(3)] + [
            (tid, 'run.snapshot', 'gauge', None, 0.0, now(), 'train',
             json.dumps({'model': 'mlp', 'batch_size': 32}))])
        assert twin.call('/api/task/postmortem', {'task': tid})[0] == 404
        live = twin.ok('/api/task/postmortem', {'task': tid, 'live': True})
        assert live['live'] is True and len(live['series']['loss']) == 3
        persist_postmortem(twin.port, tid, reason='oom')
        jax_persist_postmortem(twin.jax, tid, reason='oom')
        frozen = twin.ok('/api/task/postmortem', {'task': tid})
        assert frozen['reason'] == 'oom'
        assert frozen['context']['run.snapshot']['tags']['model'] == 'mlp'
        status, got = twin.call(f'/api/task/postmortem?task={tid}',
                                method='GET', token=None)
        assert status == 200 and got == frozen
        assert twin.call('/api/task/postmortem', {'task': 999999})[0] == 404

    def test_profile_start_status_stop(self, twin, dag):
        """The request row's lifecycle as the JAX server writes it (its
        ``ts`` is each server's clock); the token is required."""
        tid = twin.tasks['write'][0]
        jax_base = f'http://127.0.0.1:{twin.jax_server.port}'
        port_base = f'http://127.0.0.1:{twin.port_server.port}'
        for data, status in (({'task': tid, 'action': 'status'}, 200),
                             ({'task': tid, 'dir': '/x',
                               'max_epochs': 2}, 200),
                             ({'task': tid, 'action': 'status'}, 200),
                             ({'task': tid, 'action': 'stop'}, 200),
                             ({'task': tid, 'action': 'status'}, 200),
                             ({'task': tid, 'action': 'bogus'}, 400),
                             ({'action': 'status'}, 400)):
            got = [_request(base, '/api/telemetry/profile', data)
                   for base in (jax_base, port_base)]
            assert got[0][0] == got[1][0] == status, (data, got)
            if status == 200:
                theirs, mine = ({k: v for k, v in body.items() if k != 'ts'}
                                for _, body in got)
                assert mine == theirs and mine['task'] == tid
        assert mine['status'] == 'stop_requested' and mine['max_epochs'] == 2
        assert twin.call('/api/telemetry/profile', {'task': tid},
                         token='wrong')[0] == 401


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize('route', sorted(api.WAITING_ROUTES))
def test_waiting_route_refuses_with_its_roadmap_item(twin, route):
    """A route whose module is not ported answers 501 and names the
    ROADMAP.md item it waits for; none returns data made up to look
    empty. The JAX server serves the same route."""
    status, body = twin.port_call(route, {'id': 1, 'task': 1})
    item = api.WAITING_ROUTES[route]
    assert status == 501 and body['success'] is False
    assert item in body['reason'] and route in body['reason']
    with open(os.path.join(REPO, 'ROADMAP.md')) as fh:
        roadmap = ' '.join(fh.read().split())   # lines rewrapped
    assert item.split(': ', 1)[-1] in roadmap
    assert route in jax_api._ROUTES


def test_waiting_get_mirrors_refuse(twin):
    for route in ('/api/fleets', '/api/sweeps', '/api/usage', '/api/slos'):
        status, body = twin.port_call(route + '?task=1', method='GET',
                                      token=None)
        assert status == 501 and route in body['reason'], route


# --------------------------------------------------------------- dashboard
def test_dashboard_is_jax_page_but_the_listed_differences(twin):
    page = dashboard_html()
    for theirs, ours in DASHBOARD_DIFFERENCES:
        assert page.count(ours) == 1
        page = page.replace(ours, theirs)
    assert page == jax_dashboard_html()
    status, raw = twin.call('/', method='GET', token=None)
    assert status == 200 and raw.decode() == dashboard_html()
    assert twin.call('/ui', method='GET', token=None)[0] == 200


def test_every_dashboard_call_has_a_route():
    page = dashboard_html()
    calls = set(re.findall(r"api\('([^']+)'", page))
    assert len(calls) > 40
    for path in calls:
        if path.endswith('/'):      # api('dag/' + action)
            for action in ('stop', 'start', 'remove'):
                assert f'/api/{path}{action}' in api._ROUTES
        else:
            assert f'/api/{path}' in api._ROUTES, path
    assert set(api._ROUTES) == set(jax_api._ROUTES)


# ----------------------------------------------------------------- metrics
def test_metrics_families_equal_but_the_waiting(twin, dag):
    tid = twin.tasks['write'][0]
    twin.both_sql("UPDATE task SET status=?, computer_assigned='h1', "
                  "cores_assigned='[0]' WHERE id=?",
                  (int(TaskStatus.InProgress), tid))
    for session in (twin.jax, twin.port):
        session.execute(
            "INSERT INTO computer (name, cores, cpu, memory, ip, "
            "can_process_tasks) VALUES ('h1', 2, 8, 32.0, 'x', 1)")
        session.execute(
            "INSERT INTO queue_message (queue, payload, status, created) "
            "VALUES ('h1_default', '{}', 'pending', ?)", (now(),))
        session.executemany(
            'INSERT INTO metric (task, name, kind, step, value, time, '
            'component, tags) VALUES (?, ?, ?, ?, ?, ?, ?, ?)',
            [(tid, 'task.retry', 'counter', 1, 1.0, now(), 'supervisor',
              '{"reason": "preempted"}'),
             (None, 'supervisor.failover', 'counter', 2, 1.0, now(),
              'supervisor', '{"first_boot": 0}'),
             (tid, 'device0.hbm_used', 'gauge', 1, 5.0, now(), 'train',
              None),
             (tid, 'step.phase.compute_ms', 'series', 1, 7.5, now(),
              'train', None),
             (tid, 'step.phase.compute_ms', 'series', 2, 8.5, now(),
              'train', None),
             (tid, 'step.phase.data_wait_ms', 'series', 2, 0.5, now(),
              'train', None),
             (tid, 'step.pipeline_efficiency', 'gauge', 0, 0.9, now(),
              'train', None)])
        session.execute(
            "UPDATE supervisor_lease SET holder='h1:1:a', epoch=2, "
            "expires_at=? WHERE id=1", ('2999-01-01 00:00:00.000000',))
    texts = []
    for server in (twin.jax_server, twin.port_server):
        status, raw = _request(f'http://127.0.0.1:{server.port}',
                               '/metrics', method='GET', token=None)
        assert status == 200
        texts.append(raw.decode())
    theirs = jax_parse_openmetrics(texts[0])
    mine = parse_openmetrics(texts[1])
    assert set(REQUIRED_FAMILIES) <= set(mine)
    assert set(theirs) - set(mine) == set(WAITING_FAMILIES)
    assert set(mine) <= set(theirs)
    waiting_collectors = {'fleet_replicas', 'quota'}
    for name in mine:
        a, b = mine[name], theirs[name]
        assert a['type'] == b['type'], name
        if name == 'mlcomp_scrape_duration_seconds':
            continue
        samples = b['samples']
        if name == 'mlcomp_scrape_errors':
            samples = [s for s in samples
                       if s[1]['collector'] not in waiting_collectors]
            assert all(v == 0 for _, _, v in a['samples'])
        assert a['samples'] == samples, name
    assert sorted(s[1]['phase'] for s in
                  mine['mlcomp_step_phase_ms']['samples']) == [
        'compute', 'data_wait']
    assert mine['mlcomp_pipeline_efficiency']['samples'] == [
        ('mlcomp_pipeline_efficiency', {'task': str(tid)}, 0.9)]
    counts = {s[1]['status']: s[2] for s in mine['mlcomp_tasks']['samples']}
    assert counts['in_progress'] == 1 and counts['not_ran'] == 1
    assert mine['mlcomp_supervisor_epoch']['samples'][0][2] == 2
    assert mine['mlcomp_supervisor_failovers']['samples'][0][2] == 1


# -------------------------------------------------------------- robustness
class TestRobustness:
    def test_invalid_json_is_400(self, twin):
        status, body = twin.call('/api/tasks', raw=b'{not json')
        assert status == 400 and body['reason'] == 'invalid json'
        assert 'data' in twin.ok('/api/tasks', {})

    def test_unknown_ids_do_not_wedge(self, twin):
        for path, payload in [('/api/graph', {'id': 99999}),
                              ('/api/config', {'id': 99999}),
                              ('/api/task/info', {'id': 99999}),
                              ('/api/task/stop', {'id': 99999}),
                              ('/api/report', {'id': 99999})]:
            twin.call(path, payload)
        assert 'data' in twin.ok('/api/tasks', {})

    def test_wrong_types_do_not_wedge(self, twin):
        for path, payload in [('/api/tasks', {'dag': 'not-an-int'}),
                              ('/api/logs', {'task': {'nested': 'dict'}}),
                              ('/api/task/stop', {'id': None}),
                              ('/api/telemetry/spans', {'task': 'x'})]:
            status, body = twin.call(path, payload)
            assert status == 200 or body['success'] is False
        assert 'data' in twin.ok('/api/tasks', {})


def test_heal_retries_reads_only(twin, monkeypatch):
    """A closed connection mid-request (another thread healed the
    session) is retried once on a read-only route, and never on a
    write: a write handler may have committed its first statements."""
    calls = {'read': 0, 'write': 0}

    def flaky(kind):
        def handler(data, s):
            calls[kind] += 1
            if calls[kind] == 1:
                raise sqlite3.ProgrammingError('closed database')
            return {'ok': kind}
        return handler

    monkeypatch.setitem(api._ROUTES, '/api/logs', (flaky('read'), True))
    monkeypatch.setitem(api._ROUTES, '/api/remove_files',
                        (flaky('write'), True))
    assert twin.port_call('/api/logs') == (200, {'ok': 'read'})
    status, _ = twin.port_call('/api/remove_files', {'dag': 1})
    assert status == 500 and calls == {'read': 2, 'write': 1}
    # the heal reopened the same DB, not the root's
    assert api._session().connection_string == twin.port.connection_string
    assert twin.port_call('/api/tasks')[0] == 200


class TestShutdown:
    def test_shutdown_requires_auth(self, twin):
        assert twin.call('/api/shutdown', token='bad')[0] == 401

    def test_shutdown(self, twin):
        """The servers of this test alone: shutdown ends them."""
        own = (jax_api.ApiServer(host='127.0.0.1', port=0),
               api.ApiServer(host='127.0.0.1', port=0))
        for server in own:
            thread = threading.Thread(target=server.serve_forever)
            thread.start()
            status, body = _request(f'http://127.0.0.1:{server.port}',
                                    '/api/shutdown')
            assert status == 200 and body['success']
            thread.join(timeout=10)
            assert not thread.is_alive()
            server.httpd.server_close()


# ------------------------------------------------------------- processes
def _fake_procs(monkeypatch, os_module, table):
    """Serve ``table`` ({pid: command line}) as this host's processes and
    record the signals sent to them."""
    from mlcomp_tpu_torch.utils import procfs
    killed = []
    monkeypatch.setattr(procfs, 'process_pids', lambda: sorted(table))
    monkeypatch.setattr(procfs, 'process_cmdline', lambda pid: table[pid])
    monkeypatch.setattr(os_module, 'kill',
                        lambda pid, sig: killed.append((pid, sig)))
    return killed


PROCS = {
    11: 'python -m mlcomp_tpu_torch.worker worker 0',
    12: 'python -m mlcomp_tpu_torch.worker start 1',
    13: 'python -m mlcomp_tpu_torch.server start-site',
    14: 'python -m mlcomp_tpu_torch.server start 1',
    15: 'python -m mlcomp_tpu.worker worker 0',
    16: 'python -m mlcomp_tpu_torch.worker worker-supervisor',
}


def test_api_stop_terminates_workers_group_parents_first(monkeypatch):
    """``/api/stop`` finds the worker daemons through ``/proc``
    (utils/procfs.py, no psutil): the ``worker start`` parent first, then
    every worker process; the site and JAX's daemons stay."""
    killed = _fake_procs(monkeypatch, os, PROCS)
    res = api.api_stop({}, None)
    assert [pid for pid, _ in killed] == [12, 11, 12, 16]
    assert all(sig == signal.SIGTERM for _, sig in killed)
    assert res == {'success': True, 'stopped': [11, 12, 16]}


def test_server_stop_terminates_the_group_parents_first(monkeypatch,
                                                        capsys):
    import mlcomp_tpu_torch.server.__main__ as server_main
    killed = _fake_procs(monkeypatch, server_main.os, PROCS)
    server_main.main(['stop'])
    assert [pid for pid, _ in killed] == [12, 14, 11, 13, 16]
    assert capsys.readouterr().out.strip() == 'stopped'


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_start_site_in_a_subprocess_without_click_psutil_yaml_jax(tmp_path):
    """``start-site`` where importing click, psutil, PyYAML, JAX, the JAX
    package or torch raises: ``/api/token`` answers, the supervisor
    holds the lease, and SIGTERM releases it in the row and exits 0."""
    from tests.test_torch_port_imports import _BLOCKER, FORBIDDEN
    port = _free_port()
    root = tmp_path / 'root'
    code = _BLOCKER.format(
        blocked=FORBIDDEN + ('torch',), module='mlcomp_tpu_torch.server',
        argv=['start-site', '--host', '127.0.0.1'])
    env = dict(os.environ, MLCOMP_TPU_ROOT=str(root), WEB_PORT=str(port),
               PYTHONPATH=REPO)
    env.pop('PYTEST_XDIST_WORKER', None)
    proc = subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, body = _request(f'http://127.0.0.1:{port}',
                                        '/api/token', {'token': TOKEN})
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert (status, body) == (200, {'success': True})
        db = sqlite3.connect(str(root / 'db' / 'sqlite.db'))
        while db.execute('SELECT holder FROM supervisor_lease'
                         ).fetchone()[0] is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        holder, epoch = db.execute(
            'SELECT holder, epoch FROM supervisor_lease').fetchone()
        assert holder.split(':')[1] == str(proc.pid) and epoch == 1
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=30)[0].decode()
        assert proc.returncode == 0, out
        assert db.execute('SELECT holder, epoch FROM supervisor_lease'
                          ).fetchone() == (None, 1)
        db.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

"""The port's sqlite store (``mlcomp_tpu_torch/db``) against the JAX
package's on the CPU: the migrated schema (``sqlite_master``, the version,
the seeded layouts), each package opening the other's DB as current,
rows written by one package's providers read field for field by the
other's, the refusal of a non-sqlite DB, and the trace spans, metric
series and log rows the pipeline writes."""

import sqlite3

import numpy as np
import pytest

from mlcomp_tpu.db import models as jax_models
from mlcomp_tpu.db import providers as jax_providers
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu_torch.db import models as port_models
from mlcomp_tpu_torch.db import providers as port_providers
from mlcomp_tpu_torch.db.core import Session, adapt_value
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.utils.misc import now


def _sessions(tmp_path, name):
    """A JAX and a port session on two fresh files, each migrated by its
    own package."""
    jax_s = JaxSession.create_session(
        key=f'jax-{tmp_path}-{name}',
        connection_string=f'sqlite:///{tmp_path}/{name}_jax.db')
    port_s = Session.create_session(
        key=f'port-{tmp_path}-{name}',
        connection_string=f'sqlite:///{tmp_path}/{name}_port.db')
    return jax_s, port_s


@pytest.fixture()
def pair(tmp_path):
    jax_s, port_s = _sessions(tmp_path, 'pair')
    jax_migrate(jax_s)
    migrate(port_s)
    yield jax_s, port_s
    JaxSession.cleanup(jax_s.key)
    Session.cleanup(port_s.key)


def _master(path) -> list:
    conn = sqlite3.connect(path)
    try:
        return sorted(
            (t, n, ' '.join((sql or '').split())) for t, n, sql in
            conn.execute('SELECT type, name, sql FROM sqlite_master'))
    finally:
        conn.close()


def test_migrated_schemas_are_identical(pair, tmp_path):
    jax_s, port_s = pair
    assert _master(jax_s.db_path) == _master(port_s.db_path)
    assert len(_master(port_s.db_path)) > 100


def test_migration_version_and_layouts(pair):
    jax_s, port_s = pair

    def version(s):
        return s.query_one('SELECT MAX(version) AS v FROM migration_'
                           'version')['v']

    def layouts(s):
        return [tuple(r) for r in s.query(
            'SELECT name, content FROM report_layout ORDER BY id')]
    assert version(jax_s) == version(port_s) == 15
    assert layouts(jax_s) == layouts(port_s) and len(layouts(port_s)) == 4
    lease = 'SELECT id, holder, epoch FROM supervisor_lease'
    assert [tuple(r) for r in jax_s.query(lease)] == \
        [tuple(r) for r in port_s.query(lease)] == [(1, None, 0)]


@pytest.mark.parametrize('direction', ['port_opens_jax', 'jax_opens_port'])
def test_each_package_opens_the_others_db_as_current(pair, direction):
    jax_s, port_s = pair
    if direction == 'port_opens_jax':
        other = Session.create_session(
            key=f'{jax_s.key}-other',
            connection_string=jax_s.connection_string)
        run, path, cleanup = migrate, jax_s.db_path, Session.cleanup
    else:
        other = JaxSession.create_session(
            key=f'{port_s.key}-other',
            connection_string=port_s.connection_string)
        run, path, cleanup = jax_migrate, port_s.db_path, JaxSession.cleanup
    before = _master(path)
    try:
        assert run(other) == 15
        rows = other.query_one('SELECT COUNT(*) AS c FROM migration_version')
        assert rows['c'] == 15
        assert _master(path) == before
    finally:
        cleanup(other.key)


def _write_rows(models, providers, session, prefix):
    """A project, dag, task, dependency, two steps and a log row,
    through a package's own providers; returns the ids."""
    project = providers.ProjectProvider(session).add_project(f'{prefix}_p')
    dag = models.Dag(name=f'{prefix}_dag', config='a: 1\n',
                     project=project.id, created=now(), owner='o',
                     priority='high', type=0)
    providers.DagProvider(session).add(dag)
    tp = providers.TaskProvider(session)
    tasks = []
    for name in ('a', 'b'):
        task = models.Task(
            name=name, executor=name, dag=dag.id, cores=1, cores_max=2,
            status=int(TaskStatus.NotRan), type=1, debug=True,
            additional_info='trace_id: x\n', last_activity=now(),
            owner='o', project=f'{prefix}_p', single_node=True,
            memory=0.5, cpu=2, gpu_requirement='1-2')
        tp.add(task)
        tasks.append(task)
    tp.add_dependency(tasks[1].id, tasks[0].id)
    tp.change_status(tasks[0], TaskStatus.InProgress)
    tp.fail_with_reason(tasks[0], 'executor-error')
    sp = providers.StepProvider(session)
    root = models.Step(task=tasks[0].id, level=1, name='root', index=0,
                       started=now())
    sp.add(root)
    child = models.Step(task=tasks[0].id, level=2, name='child', index=3,
                        started=now())
    sp.add(child)
    child.finished = now()
    sp.update(child, ['finished'])
    session.add(models.Log(message='hello', time=now(), level=1,
                           component=int(ComponentType.Worker),
                           module='m:f', line=7, task=tasks[0].id,
                           step=child.id, computer='host'))
    return dag.id, [t.id for t in tasks], [root.id, child.id]


def _read_rows(providers, session, dag_id, task_ids, step_ids):
    out = {'dag': providers.DagProvider(session).by_id(dag_id).to_dict()}
    tp = providers.TaskProvider(session)
    out['tasks'] = [tp.by_id(t).to_dict() for t in task_ids]
    out['deps'] = {t: sorted(s) for t, s in
                   tp.dependency_status(task_ids).items()}
    out['steps'] = [s.to_dict() for s in
                    providers.StepProvider(session).by_task(task_ids[0])]
    out['logs'] = [{k: v for k, v in r.items() if k != 'id'} for r in
                   providers.LogProvider(session).get(
                       {'task': task_ids[0]})['data']]
    return out


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_rows_read_field_for_field_by_the_other(pair, writer):
    jax_s, port_s = pair
    if writer == 'port':
        ids = _write_rows(port_models, port_providers, port_s, 'w')
        session, reader = port_s, JaxSession.create_session(
            key=f'{port_s.key}-r', connection_string=port_s.connection_string)
    else:
        ids = _write_rows(jax_models, jax_providers, jax_s, 'w')
        session, reader = jax_s, Session.create_session(
            key=f'{jax_s.key}-r', connection_string=jax_s.connection_string)
    try:
        mine = _read_rows(port_providers if writer == 'port'
                          else jax_providers, session, *ids)
        theirs = _read_rows(jax_providers if writer == 'port'
                            else port_providers, reader, *ids)
        assert mine == theirs
        assert theirs['tasks'][0]['failure_reason'] == 'executor-error'
        assert theirs['tasks'][0]['status'] == int(TaskStatus.Failed)
        assert [s['name'] for s in theirs['steps']] == ['root', 'child']
        assert theirs['logs'][0]['message'] == 'hello'
    finally:
        (JaxSession if writer == 'port' else Session).cleanup(reader.key)


@pytest.mark.parametrize('url', ['postgresql://u:p@localhost:5432/db',
                                 'http://localhost:4201'])
def test_a_non_sqlite_db_raises_naming_a0(url):
    with pytest.raises(NotImplementedError, match='A0'):
        Session.create_session(key=f'refused-{url}', connection_string=url)


@pytest.mark.parametrize('value', [
    np.int64(3), np.float32(0.5), np.array([1, 2]), True,
    TaskStatus.Success, 'text', None, 1.5])
def test_values_adapt_as_in_jax(value):
    from mlcomp_tpu.db.core import adapt_value as jax_adapt
    from mlcomp_tpu.db.enums import TaskStatus as JaxTaskStatus
    theirs = jax_adapt(JaxTaskStatus(int(value))
                       if isinstance(value, TaskStatus) else value)
    assert adapt_value(value) == theirs
    assert type(adapt_value(value)) is type(theirs)


def test_spans_and_metrics_rows_read_by_jax(pair):
    """Spans flushed and a recorder's metric rows, read through the JAX
    package's providers; a value on a device is dropped, not pulled."""
    from mlcomp_tpu_torch.telemetry import (
        MetricRecorder, flush_spans, record_span, span,
    )
    from mlcomp_tpu_torch.telemetry.spans import SpanBuffer
    jax_s, port_s = pair
    buf = SpanBuffer()
    with span('outer', task=7, buffer=buf, trace_id='t1', role='worker'):
        with span('inner', buffer=buf, tags={'k': 1}):
            pass
    record_span('timed', started=1.0, duration=2.0, task=7, buffer=buf)
    assert flush_spans(port_s, buffer=buf) == 3
    reader = JaxSession.create_session(
        key=f'{port_s.key}-tel', connection_string=port_s.connection_string)
    try:
        tree = jax_providers.TelemetrySpanProvider(reader).tree(7)
        names = sorted(s['name'] for s in tree)
        assert names == ['outer', 'timed']
        outer = next(s for s in tree if s['name'] == 'outer')
        assert [c['name'] for c in outer['children']] == ['inner']

        class OnDevice:
            is_cuda = True
        rec = MetricRecorder(session=port_s, task=7, component='train')
        rec.gauge('loss', 1.5, step=0)
        rec.gauge('epoch_time_s', np.float32(2.0))
        rec.gauge('loss', OnDevice(), step=1)
        rec.observe('latency', 0.25)
        assert rec.flush() > 0 and rec.dropped_count == 1
        rows = jax_providers.MetricProvider(reader).series(task_id=7)
        by_name = {(name, r['kind']): r['value']
                   for name, samples in rows.items() for r in samples}
        assert by_name[('loss', 'gauge')] == 1.5
        assert by_name[('epoch_time_s', 'gauge')] == 2.0
        assert by_name[('latency.p50', 'histogram')] == 0.25
    finally:
        JaxSession.cleanup(reader.key)


def test_db_handler_attaches_logs_to_the_step(pair):
    from mlcomp_tpu_torch.utils.logging import DbHandler, create_logger
    _, port_s = pair
    logger = create_logger(port_s)
    handler = next(h for h in logger.handlers if isinstance(h, DbHandler))
    handler.session = port_s
    logger.info('attached', int(ComponentType.Worker), 'host', 11, 12)
    row = port_s.query_one('SELECT * FROM log WHERE task=11')
    assert (row['message'], row['step'], row['computer'],
            row['component']) == ('attached', 12, 'host',
                                  int(ComponentType.Worker))

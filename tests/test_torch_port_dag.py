"""The port's DAG builder and preflight against the JAX package's, on
the CPU: for every example config ``tests/test_examples.py`` builds, the
dag, task, dependency, report and stored-code rows each package's
``dag_standard`` writes into its own DB (ids and the random ``trace_id``
aside); the ``tests/configs/broken`` corpus through both
``preflight_config``s; the ``--params`` merge; and the port's ``check``
and ``dag`` commands."""

import glob
import os
import shutil

import pytest
import yaml

from mlcomp_tpu.analysis import folder_sources as jax_folder_sources
from mlcomp_tpu.analysis import preflight_config as jax_preflight
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.db.migration import migrate as jax_migrate
from mlcomp_tpu.server.create_dags.standard import (
    dag_standard as jax_dag_standard,
)
from mlcomp_tpu.utils.config import merge_dicts_smart as jax_merge
from mlcomp_tpu_torch.analysis import folder_sources, preflight_config
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.server.create_dags.standard import parse_cores
from mlcomp_tpu_torch.utils.config import (
    dict_from_list_str, merge_dicts_smart,
)
from mlcomp_tpu_torch.utils.io import yaml_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_CONFIGS = sorted(glob.glob(os.path.join(REPO, 'examples', '*',
                                                '*.yml')))
BROKEN = sorted(glob.glob(os.path.join(REPO, 'tests', 'configs', 'broken',
                                       '*.yml')))


@pytest.fixture()
def sessions(tmp_path):
    jax_s = JaxSession.create_session(
        key=f'dag-jax-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/jax.db')
    port_s = Session.create_session(
        key=f'dag-port-{tmp_path}',
        connection_string=f'sqlite:///{tmp_path}/port.db')
    jax_migrate(jax_s)
    migrate(port_s)
    yield jax_s, port_s
    JaxSession.cleanup(jax_s.key)
    Session.cleanup(port_s.key)


def _info(text):
    info = yaml.safe_load(text) if text else {}
    info.pop('trace_id', None)
    return info


def dag_rows(session, dag_id) -> dict:
    """Every row a build wrote, keyed by names instead of ids; times and
    the trace id dropped, YAML text parsed."""
    q = session.query
    dag = dict(q('SELECT * FROM dag WHERE id=?', (dag_id,))[0])
    project = dict(q('SELECT * FROM project WHERE id=?',
                     (dag['project'],))[0])
    reports = {r['id']: r for r in q('SELECT * FROM report')}
    tasks = [dict(r) for r in q('SELECT * FROM task WHERE dag=? '
                                'ORDER BY id', (dag_id,))]
    names = {t['id']: t['name'] for t in tasks}
    out = {
        'project': {k: project[k] for k in ('name', 'class_names',
                                            'ignore_folders')},
        'dag': {**{k: v for k, v in dag.items() if k not in (
                    'id', 'created', 'project', 'report', 'config')},
                'config': yaml.safe_load(dag['config']),
                'report': reports[dag['report']]['name']
                if dag['report'] else None},
        'tasks': [{**{k: v for k, v in t.items() if k not in (
                      'id', 'dag', 'last_activity', 'report',
                      'additional_info')},
                   'additional_info': _info(t['additional_info']),
                   'report': reports[t['report']]['name']
                   if t['report'] else None} for t in tasks],
        'dependencies': sorted(
            (names[r['task_id']], names[r['depend_id']]) for r in q(
                'SELECT * FROM task_dependence WHERE task_id IN '
                '(SELECT id FROM task WHERE dag=?)', (dag_id,))),
        'reports': sorted(
            (r['name'], r['layout'], yaml.safe_dump(yaml.safe_load(
                r['config']))) for r in reports.values()),
        'report_tasks': sorted(
            (reports[r['report']]['name'], names[r['task']]) for r in q(
                'SELECT * FROM report_tasks')),
        'storage': sorted(
            (r['path'], bool(r['is_dir']), r['md5']) for r in q(
                'SELECT s.path, s.is_dir, f.md5 FROM dag_storage s LEFT '
                'JOIN file f ON s.file = f.id WHERE s.dag=?', (dag_id,))),
        'libraries': sorted(tuple(r) for r in q(
            'SELECT library, version FROM dag_library WHERE dag=?',
            (dag_id,))),
    }
    return out


@pytest.mark.parametrize(
    'config_path', EXAMPLE_CONFIGS,
    ids=['/'.join(p.split(os.sep)[-2:]) for p in EXAMPLE_CONFIGS])
def test_builder_rows_equal_jax(sessions, config_path):
    jax_s, port_s = sessions
    folder = os.path.dirname(config_path)
    upload = folder if os.path.exists(
        os.path.join(folder, 'executors.py')) else None
    jax_dag, jax_tasks = jax_dag_standard(
        jax_s, yaml.safe_load(open(config_path)), upload_folder=upload)
    port_dag, port_tasks = dag_standard(
        port_s, yaml_load(file=config_path), upload_folder=upload)
    assert set(port_tasks) == set(jax_tasks)
    assert {k: len(v) for k, v in port_tasks.items()} == \
        {k: len(v) for k, v in jax_tasks.items()}
    mine, theirs = dag_rows(port_s, port_dag.id), dag_rows(jax_s, jax_dag.id)
    for key in theirs:
        assert mine[key] == theirs[key], key
    assert mine['tasks']


def test_upload_digests_are_md5_of_the_files(sessions):
    """The stored blobs are the files, by the digests the JAX package's
    native hash pass gives."""
    from mlcomp_tpu import native
    _, port_s = sessions
    folder = os.path.join(REPO, 'examples', 'hierarchical_logging')
    dag, _ = dag_standard(port_s, yaml_load(
        file=os.path.join(folder, 'config.yml')), upload_folder=folder)
    rows = port_s.query('SELECT s.path, f.md5, f.content FROM dag_storage s '
                        'JOIN file f ON s.file = f.id WHERE s.dag=?',
                        (dag.id,))
    paths = [os.path.join(folder, r['path']) for r in rows]
    assert [r['md5'] for r in rows] == native.hash_files(paths)
    for row, path in zip(rows, paths):
        with open(path, 'rb') as fh:
            assert row['content'] == fh.read()


def _dag_findings(findings):
    return sorted((f.rule, f.severity, f.path, f.message) for f in findings
                  if f.rule.startswith('dag-'))


@pytest.mark.parametrize('path', BROKEN, ids=os.path.basename)
def test_broken_corpus_gives_jax_rule_ids(path):
    folder = os.path.dirname(path)
    config = yaml.safe_load(open(path))
    theirs = _dag_findings(jax_preflight(
        config, sources=jax_folder_sources(folder)))
    mine = _dag_findings(preflight_config(
        yaml_load(file=path), sources=folder_sources(folder)))
    assert mine == theirs and any(f[1] == 'error' for f in mine)


@pytest.mark.parametrize('name', ['cifar_simple', 'encoder_grid',
                                  'hierarchical_logging', 'ensemble'])
def test_examples_the_slice_runs_preflight_clean(name):
    folder = os.path.join(REPO, 'examples', name)
    config = yaml_load(file=os.path.join(folder, 'config.yml'))
    mine = _dag_findings(preflight_config(
        config, sources=folder_sources(folder)))
    theirs = _dag_findings(jax_preflight(
        yaml.safe_load(open(os.path.join(folder, 'config.yml'))),
        sources=jax_folder_sources(folder)))
    assert mine == theirs == []


@pytest.mark.parametrize('params', [
    ['model/norm:fused'], ['lr:0.01'], ['batch_size:128', 'seed:3'],
    ['stages:x'], ['main_metric:loss', 'minimize:True']])
def test_params_merge_as_jax(params):
    config = yaml.safe_load(open(os.path.join(
        REPO, 'examples', 'cifar_simple', 'config.yml')))
    from mlcomp_tpu.utils.config import dict_from_list_str as jax_parse
    overrides = dict_from_list_str(params)
    assert overrides == jax_parse(params)
    merged = merge_dicts_smart(config, overrides)
    assert merged == jax_merge(config, jax_parse(params))
    if params == ['model/norm:fused']:
        assert merged['executors']['train']['model']['norm'] == 'fused'


@pytest.mark.parametrize('spec,want', [
    (None, (0, 0)), (3, (3, 3)), ('2-4', (2, 4)), ('1', (1, 1))])
def test_parse_cores(spec, want):
    assert parse_cores(spec) == want


def test_a_sweep_block_raises_before_any_row(sessions):
    """A sweep block is ported: one without a rung boundary raises
    JAX's ``ValueError`` before any task or sweep row (the dag row is
    written first, by both builders), and with one it builds JAX's
    rows, the sweep spec stamped on each cell."""
    jax_s, port_s = sessions

    def config(**sweep):
        return {'info': {'name': 's', 'project': 'p'}, 'executors': {
            'train': {'type': 'jax_train', 'grid': [{'lr': [0.1, 0.2]}],
                      'sweep': {'metric': 'accuracy', **sweep}}}}

    with pytest.raises(ValueError) as theirs:
        jax_dag_standard(jax_s, config())
    with pytest.raises(ValueError, match='exactly one of rung_epochs') \
            as mine:
        dag_standard(port_s, config())
    assert str(mine.value) == str(theirs.value)
    for table in ('dag', 'task', 'sweep'):
        count = f'SELECT COUNT(*) AS c FROM {table}'
        assert port_s.query_one(count)['c'] == \
            jax_s.query_one(count)['c'] == (table == 'dag')
    jax_dag, _ = jax_dag_standard(jax_s, config(rung_epochs=2))
    port_dag, _ = dag_standard(port_s, config(rung_epochs=2))
    assert dag_rows(port_s, port_dag.id) == dag_rows(jax_s, jax_dag.id)
    cells = port_s.query('SELECT additional_info FROM task WHERE dag=?',
                         (port_dag.id,))
    assert [_info(c['additional_info'])['sweep']['base'] for c in cells] \
        == [2, 2]


# ------------------------------------------------------------- commands
@pytest.fixture()
def cli_db(tmp_path, monkeypatch):
    """The port's CLI on a DB of its own (the default session)."""
    import mlcomp_tpu_torch
    Session.cleanup('default')
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING',
                        f'sqlite:///{tmp_path}/cli.db')
    yield tmp_path
    Session.cleanup('default')


@pytest.mark.parametrize('path,code', [
    (os.path.join(REPO, 'examples', 'cifar_simple', 'config.yml'), 0),
    (os.path.join(REPO, 'tests', 'configs', 'broken', 'cycle.yml'), 1),
    ('/nonexistent/config.yml', 2)])
def test_check_exit_codes(path, code, capsys):
    from mlcomp_tpu_torch.__main__ import main
    if code:
        with pytest.raises(SystemExit) as e:
            main(['check', path])
        assert e.value.code == code
    else:
        main(['check', path])
    out = capsys.readouterr()
    if code != 2:
        assert 'code lint not run' in out.out and 'A8' in out.out


def test_dag_command_writes_the_rows(cli_db, capsys):
    from mlcomp_tpu_torch.__main__ import main
    main(['dag', os.path.join(REPO, 'examples', 'encoder_grid',
                              'config.yml'), '--priority', 'high'])
    assert capsys.readouterr().out.strip().endswith(
        'created with 6 tasks')
    s = Session.create_session()
    rows = dag_rows(s, 1)
    assert len(rows['tasks']) == 6
    assert {t['priority'] for t in rows['tasks']} == {'high'}
    assert rows['dag']['priority'] == 'high'


def test_dag_command_rejects_a_broken_config_before_any_row(cli_db,
                                                            capsys):
    from mlcomp_tpu_torch.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(['dag', os.path.join(REPO, 'tests', 'configs', 'broken',
                                  'cycle.yml')])
    assert e.value.code == 1
    assert 'preflight rejected the DAG' in capsys.readouterr().err
    assert not os.path.exists(os.path.join(str(cli_db), 'cli.db'))


def test_params_are_stored_merged(cli_db, tmp_path):
    from mlcomp_tpu_torch.__main__ import main
    folder = tmp_path / 'exp'
    shutil.copytree(os.path.join(REPO, 'examples', 'cifar_simple'), folder)
    main(['dag', str(folder / 'config.yml'), '--params',
          'model/norm:fused'])
    s = Session.create_session()
    config = yaml.safe_load(s.query_one('SELECT config FROM dag')['config'])
    assert config['executors']['train']['model'] == {
        'name': 'resnet18', 'num_classes': 10, 'dtype': 'bfloat16',
        'norm': 'fused'}

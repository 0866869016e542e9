"""The port's trainer with device telemetry, on the CPU (a small MLP),
read back by the JAX package's readers: a ``train`` task run with a DB
session and a task writes the step phases, step times, throughput, the
pipeline efficiency, the MFU, the run snapshot, the memory attribution
and (the profiler windows forced on) ``devtime.*`` rows of host-only
captures; JAX's ``build_postmortem``, ``_collect_step_phases``,
``api_task_devtime`` and its ``devtime`` / ``postmortem`` commands give
from those rows what the port's give. The ``profile`` key and an
on-demand trace leave their captures in the layout the parser walks.
Last, JAX's ``TestEndToEndOomChaos``: a real run killed by the
``train.epoch`` fault ends Failed / ``oom``, is not retried, and its
frozen bundle is served by the API and the command line.

JAX's trainer is never the oracle (it aborts under xdist); its
jax-free readers are. Comparisons are exact after the bundles' and
rows' wall-clock fields are dropped."""

import json

import pytest
from click.testing import CliRunner

# the JAX worker binds HOSTNAME at import: import it before any test
# here sets MLCOMP_HOSTNAME
import mlcomp_tpu
import mlcomp_tpu.worker.__main__  # noqa: F401
import mlcomp_tpu_torch
import mlcomp_tpu_torch.worker.__main__ as wm
from mlcomp_tpu.__main__ import main as jax_cli
from mlcomp_tpu.db.core import Session as JaxSession
from mlcomp_tpu.server.api import api_task_devtime as jax_api_task_devtime
from mlcomp_tpu.server.api import (
    api_task_postmortem as jax_api_task_postmortem,
)
from mlcomp_tpu.telemetry.export import (
    _collect_step_phases as jax_collect_step_phases,
)
from mlcomp_tpu.telemetry.memory import (
    build_postmortem as jax_build_postmortem,
)
from mlcomp_tpu_torch.__main__ import main as port_cli
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.providers import (
    DockerProvider, QueueProvider, TaskProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.server.api import (
    api_task_devtime, api_task_postmortem,
)
from mlcomp_tpu_torch.server.create_dags import dag_standard
from mlcomp_tpu_torch.server.supervisor import SupervisorBuilder
from mlcomp_tpu_torch.telemetry import (
    build_postmortem, load_postmortem, request_trace, trace_status,
)
from mlcomp_tpu_torch.telemetry.export import _collect_step_phases
from mlcomp_tpu_torch.testing import faults
from mlcomp_tpu_torch.utils.logging import create_logger
from mlcomp_tpu_torch.worker.tasks import execute_by_id


def _mlp_train(epochs: int, **extra) -> dict:
    return {
        'type': 'train', 'device': 'cpu',
        'model': {'name': 'mlp', 'num_classes': 4, 'hidden': [16],
                  'dtype': 'float32'},
        'dataset': {'name': 'synthetic_images', 'n_train': 256,
                    'n_valid': 64, 'image_size': 8, 'channels': 1,
                    'num_classes': 4},
        'batch_size': 32, 'stages': [{'name': 's1', 'epochs': epochs}],
        **extra}


#: the CPU-defaulted-off parts forced on: the first step's FLOPs and
#: bytes, a profiler window every 3 steps, two dispatches long
TELEMETRY = {'flush_every': 10, 'profile_every': 3, 'profile_steps': 2,
             'cost_analysis': True, 'memory_analysis': True}


def _without_time(obj):
    """Drop the wall-clock fields (``time``, ``created``) recursively."""
    if isinstance(obj, dict):
        return {k: _without_time(v) for k, v in obj.items()
                if k not in ('time', 'created')}
    if isinstance(obj, list):
        return [_without_time(v) for v in obj]
    return obj


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """One port run of three epochs (8 steps each): windows in epoch 0,
    an on-demand trace requested before it starts (started at epoch 0's
    end, one epoch long), the ``profile`` key on epoch 2."""
    tmp = tmp_path_factory.mktemp('devtime')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mlcomp_tpu_torch, 'TASK_FOLDER', str(tmp / 'tasks'))
        url = f'sqlite:///{tmp}/run.db'
        session = Session.create_session(key=f'devtime-{tmp}',
                                          connection_string=url)
        migrate(session)
        folder = tmp / 'exp'
        folder.mkdir()
        config = {'info': {'name': 'devtime_dag', 'project': 'p_dt'},
                  'executors': {'train': _mlp_train(
                      3, telemetry=TELEMETRY,
                      profile={'epochs': [2], 'dir': str(tmp / 'epoch')})}}
        _, tasks = dag_standard(session, config, upload_folder=str(folder))
        tid = tasks['train'][0]
        request_trace(session, tid, out_dir=str(tmp / 'on_demand'))
        mp.chdir(folder)
        execute_by_id(tid, folder=str(folder), session=session)
        jax = JaxSession.create_session(key=f'devtime-{tmp}',
                                        connection_string=url)
        yield {'session': session, 'jax': jax, 'task': tid, 'url': url,
               'tmp': tmp}
        Session.cleanup(session.key)
        JaxSession.cleanup(jax.key)


def _summary_steps(run) -> list:
    return [r['step'] for r in run['session'].query(
        "SELECT step FROM metric WHERE task=? AND name='devtime.summary' "
        'ORDER BY id', (run['task'],))]


def test_the_run_writes_the_jax_trainers_rows(run):
    session, tid = run['session'], run['task']
    assert TaskProvider(session).by_id(tid).status == int(TaskStatus.Success)
    counts = {r['name']: r['n'] for r in session.query(
        'SELECT name, count(*) AS n FROM metric WHERE task=? GROUP BY name',
        (tid,))}
    for phase in ('data_wait', 'h2d', 'compute', 'telemetry'):
        assert counts[f'step.phase.{phase}_ms'] == 24
    assert counts['loss'] == 24
    assert counts['step_time_ms'] == counts['throughput'] == 23
    for name in ('step.pipeline_efficiency', 'mfu', 'epoch_time_s',
                 'epoch_throughput'):
        assert counts[name] == 3, name
    assert counts['run.snapshot'] == counts['memory.attribution'] == 1
    # a window at step 3 (captures 4-5), one at 6 (cut at epoch 0's end)
    # unless the first still parses then; epoch 1 runs under the
    # on-demand trace and epoch 2 under the profile key, which keep the
    # windows shut; the on-demand trace's parse adds one summary
    steps = _summary_steps(run)
    assert steps[0] == 3 and steps[-1] is None
    assert steps[1:-1] in ([], [6])
    # no card: no memory timeline
    assert not any(name.startswith('device') for name in counts)


def test_on_demand_and_profile_key_leave_parsed_captures(run):
    from mlcomp_tpu_torch.telemetry.trace_parse import (
        find_trace_files, parse_trace_dir,
    )
    row = trace_status(run['session'], run['task'])
    assert row['status'] == 'done' and row['epochs'] == 1
    assert row['attribution']['host']['dispatch_count'] == 8
    assert find_trace_files(row['dir'])
    epoch_trace = parse_trace_dir(str(run['tmp'] / 'epoch'))
    assert epoch_trace['host']['dispatch_count'] == 8
    assert epoch_trace['device_lines'] == 0             # no card


def test_jax_postmortem_bundle_equals_the_ports(run):
    mine = build_postmortem(run['session'], run['task'])
    theirs = jax_build_postmortem(run['jax'], run['task'])
    assert _without_time(mine) == _without_time(theirs)
    assert {'loss', 'step.pipeline_efficiency', 'mfu',
            'devtime.busy_frac'} <= set(mine['series'])
    assert mine['context']['run.snapshot']['tags']['model'] == 'mlp'
    attribution = mine['context']['memory.attribution']['tags']
    assert attribution['total_bytes'] == attribution['argument_bytes'] > 0


def test_jax_step_phase_collector_equals_the_ports(run):
    session, tid = run['session'], run['task']
    task = TaskProvider(session).by_id(tid)
    status = task.status
    session.execute('UPDATE task SET status=? WHERE id=?',
                    (int(TaskStatus.InProgress), tid))
    try:
        got = {}
        for name, collect, s in (('port', _collect_step_phases, session),
                                 ('jax', jax_collect_step_phases,
                                  run['jax'])):
            phases, eff = [], []
            collect(s, [tid], phases, eff)
            got[name] = (sorted(phases, key=str), eff)
    finally:
        session.execute('UPDATE task SET status=? WHERE id=?',
                        (status, tid))
    assert got['port'] == got['jax']
    assert len(got['port'][0]) == 4 and len(got['port'][1]) == 1


@pytest.mark.parametrize('tail', [None, 1])
def test_jax_devtime_route_equals_the_ports(run, tail):
    data = {'task': run['task']} if tail is None else \
        {'task': run['task'], 'tail': tail}
    mine = api_task_devtime(dict(data), run['session'])
    theirs = jax_api_task_devtime(dict(data), run['jax'])
    assert _without_time(mine) == _without_time(theirs)
    assert mine['windows'] == (len(_summary_steps(run)) if tail is None
                               else 1)


@pytest.fixture()
def default_db(run, monkeypatch):
    """Both packages' default session on the run's DB (the commands open
    ``Session.create_session()``)."""
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING', run['url'])
    monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', run['url'])
    Session.cleanup('default')
    JaxSession.cleanup('default')
    yield
    Session.cleanup('default')
    JaxSession.cleanup('default')


@pytest.mark.parametrize('args', [['devtime', '{t}'],
                                  ['devtime', '{t}', '--tail', '1'],
                                  ['devtime', '{t}', '--json'],
                                  ['devtime', '999999'],
                                  ['postmortem', '{t}', '--live'],
                                  ['postmortem', '{t}']])
def test_commands_print_what_jax_prints(run, default_db, capsys, args):
    args = [a.format(t=run['task']) for a in args]
    theirs = CliRunner().invoke(jax_cli, args)
    try:
        port_cli(args)
        code = 0
    except SystemExit as e:
        code = e.code
    mine = capsys.readouterr().out
    assert code == theirs.exit_code
    if '--json' in args:
        assert _without_time(json.loads(mine)) == \
            _without_time(json.loads(theirs.output))
    else:
        assert mine == theirs.output


def test_injected_oom_kills_a_real_train_run(tmp_path, monkeypatch, capsys):
    """JAX's ``TestEndToEndOomChaos`` on the port: the injected
    RESOURCE_EXHAUSTED at the ``train.epoch`` seam of a real run (the
    worker's in-process consume after a supervisor tick) ends the task
    Failed / ``oom``; the next tick does not retry it; the frozen bundle
    holds the run's series, snapshot and memory attribution, and the
    API and the command line serve it as JAX's do."""
    root = tmp_path / 'root'
    monkeypatch.setenv('MLCOMP_HOSTNAME', 'host1')
    monkeypatch.setattr(wm, 'HOSTNAME', 'host1')
    monkeypatch.setattr(mlcomp_tpu_torch, 'TASK_FOLDER', str(root / 'tasks'))
    url = f'sqlite:///{tmp_path}/oom.db'
    monkeypatch.setattr(mlcomp_tpu_torch, 'SA_CONNECTION_STRING', url)
    monkeypatch.setattr(mlcomp_tpu, 'SA_CONNECTION_STRING', url)
    Session.cleanup('default')
    JaxSession.cleanup('default')
    session = Session.create_session(key=f'oom-{tmp_path}',
                                     connection_string=url)
    jax = JaxSession.create_session(key=f'oom-{tmp_path}',
                                    connection_string=url)
    try:
        migrate(session)
        wm.register_computer(session, cores=1)
        DockerProvider(session).heartbeat('host1', 'default')
        folder = tmp_path / 'exp'
        folder.mkdir()
        config = {'info': {'name': 'oom_dag', 'project': 'p_oom'},
                  'executors': {'train': _mlp_train(3, telemetry={
                      'flush_every': 5, 'memory_analysis': True,
                      'cost_analysis': False})}}
        _, tasks = dag_standard(session, config, upload_folder=str(folder))
        tid = tasks['train'][0]
        sup = SupervisorBuilder(
            session=session, recovery_config=RecoveryConfig(
                lease_seconds=30, backoff_base_s=0.0))
        sup.build()
        monkeypatch.chdir(tmp_path)
        faults.configure_faults({'train.epoch': {
            'action': 'raise', 'exc': 'resource', 'after': 1}})
        try:
            assert wm._consume_one(session, QueueProvider(session),
                                   create_logger(session), 0, True)
        finally:
            faults.clear_faults()
        provider = TaskProvider(session)
        task = provider.by_id(tid)
        assert task.status == int(TaskStatus.Failed)
        assert task.failure_reason == 'oom'
        sup.build()                         # never blind-retried
        task = provider.by_id(tid)
        assert task.status == int(TaskStatus.Failed)
        assert task.next_retry_at is None and (task.attempt or 0) == 0
        assert session.query(
            "SELECT * FROM metric WHERE name='task.retry'") == []

        bundle = load_postmortem(session, tid)
        assert bundle['reason'] == 'oom'
        assert len(bundle['series']['loss']) == 8      # the first epoch
        assert {'step.phase.compute_ms', 'step_time_ms'} <= \
            set(bundle['series'])
        snapshot = bundle['context']['run.snapshot']['tags']
        assert snapshot['model'] == 'mlp' and snapshot['batch_size'] == 32
        assert bundle['context']['memory.attribution']['tags'][
            'total_bytes'] > 0
        mine = api_task_postmortem({'task': tid}, session)
        assert mine == jax_api_task_postmortem({'task': tid}, jax)
        assert mine['reason'] == 'oom'
        result = CliRunner().invoke(jax_cli, ['postmortem', str(tid)])
        assert result.exit_code == 0 and 'failed: oom' in result.output
        capsys.readouterr()
        assert port_cli(['postmortem', str(tid)]) == 0
        assert capsys.readouterr().out == result.output
    finally:
        Session.cleanup(session.key)
        JaxSession.cleanup(jax.key)
        Session.cleanup('default')
        JaxSession.cleanup('default')

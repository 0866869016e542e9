"""Command line of the port (counterpart of ``mlcomp_tpu/__main__.py``),
on ``argparse``:

- ``python -m mlcomp_tpu_torch init``           — create the folders and
  migrate the DB
- ``python -m mlcomp_tpu_torch check CONFIG``   — the DAG preflight alone,
  no DB writes; exit 0 clean, 1 on error findings, 2 on analyzer error
- ``python -m mlcomp_tpu_torch dag CONFIG``     — submit a DAG: preflight,
  then the dag, task, dependency, report and code rows. A running
  supervisor (``server/supervisor.py`` ``register_supervisor``)
  dispatches its tasks onto the DB queue, and the worker daemons
  (``python -m mlcomp_tpu_torch.worker start N``) run them.
- ``python -m mlcomp_tpu_torch execute CONFIG`` — submit and run the DAG
  in-process without the scheduler, tasks in dependency order; a failed
  dependency skips its dependants. The last line is the JSON of the task
  statuses by name.

``--params a/b:c`` overrides merge into the stored config as the JAX
package's do. The DB is the JAX package's (same root, same schema):
``<root>/db/sqlite.db``. Trainers run on the card; a config asks for the
CPU with ``device: cpu``. The other commands of the JAX package (sync,
alerts, recovery, gangs, postmortem, devtime, supervisors, fleets,
sweeps, usage, quotas) and its ``server start-site`` are not ported yet
(ROADMAP.md, A0).
"""

import argparse
import json
import os
import sys

from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.utils.config import dict_from_list_str, merge_dicts_smart
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.logging import create_logger

#: ``check``'s exit codes (the JAX package's contract)
EXIT_CLEAN, EXIT_FINDINGS, EXIT_ANALYZER_ERROR = 0, 1, 2


class CliError(Exception):
    """A usage or input error: printed as ``Error: ...``, exit 1."""


def _load_config(config_path: str, params, config: dict = None):
    if config is None:
        if not os.path.exists(config_path):
            raise CliError(f'config not found: {config_path}')
        config = yaml_load(file=config_path)
    if params:
        config = merge_dicts_smart(config, dict_from_list_str(params))
        # the MERGED config goes into the dag row: tasks re-read their
        # executor spec from dag.config
        text = yaml_dump(config)
    else:
        with open(config_path) as fh:
            text = fh.read()
    return config, text


def _preflight(config_path: str, params=()):
    """(findings, config, folder): the DAG rules over the RAW config
    (``--params`` overrides are dry-run, so ambiguity is a finding)."""
    from mlcomp_tpu_torch.analysis import folder_sources, preflight_config
    if not os.path.exists(config_path):
        raise CliError(f'config not found: {config_path}')
    config = yaml_load(file=config_path)
    folder = os.path.dirname(os.path.abspath(config_path)) or '.'
    overrides = dict_from_list_str(params) if params else None
    findings = preflight_config(
        config, sources=folder_sources(folder), params=overrides)
    return findings, config, folder


def _dag(config_path: str, params=(), debug: bool = False,
         owner: str = None, priority: str = None):
    from mlcomp_tpu_torch.analysis import format_report, split_findings
    from mlcomp_tpu_torch.server.create_dags import dag_standard

    # the submit gate: errors reject BEFORE any DB write
    findings, raw, folder = _preflight(config_path, params)
    errors, warnings = split_findings(findings)
    if errors:
        raise CliError('preflight rejected the DAG:\n'
                       + format_report(errors))
    session = Session.create_session()
    migrate(session)
    config, text = _load_config(config_path, params, config=raw)
    if owner:
        config.setdefault('info', {})['owner'] = owner
    if priority:
        config.setdefault('info', {})['priority'] = priority
    logger = create_logger(session)
    if 'pipes' in config:
        raise CliError('pipe registration (dag_pipe) is not ported yet '
                       '(ROADMAP.md, A0)')
    dag, tasks = dag_standard(
        session, config, debug=debug, config_text=text,
        upload_folder=folder, logger=logger, preflight_warnings=warnings)
    if warnings:
        print(format_report(warnings))
    return session, dag, tasks, config


def cmd_init(args):
    import mlcomp_tpu_torch
    session = Session.create_session()
    migrate(session)
    print(f'initialized at {mlcomp_tpu_torch.ROOT_FOLDER}')


def cmd_dag(args):
    _, dag_row, tasks, _ = _dag(args.config, args.params, owner=args.owner,
                                priority=args.priority)
    total = sum(len(v) for v in tasks.values())
    print(f'dag {dag_row.id} created with {total} tasks')


def _findings_json(findings) -> str:
    from mlcomp_tpu_torch.analysis import CODE_LINT_NOT_RUN, split_findings
    errors, warnings = split_findings(findings)
    return json.dumps({'findings': [f.to_dict() for f in findings],
                       'counts': {'total': len(findings),
                                  'error': len(errors),
                                  'warning': len(warnings)},
                       'code_lint': CODE_LINT_NOT_RUN})


def cmd_check(args):
    from mlcomp_tpu_torch.analysis import format_report, split_findings
    if args.code:
        print('analyzer error: the code lint (--code) is not ported yet '
              '(ROADMAP.md, A8)', file=sys.stderr)
        return EXIT_ANALYZER_ERROR
    if not args.config:
        raise CliError('give a CONFIG to preflight')
    if not os.path.exists(args.config):
        print(f'analyzer error: config not found: {args.config}',
              file=sys.stderr)
        return EXIT_ANALYZER_ERROR
    try:
        findings, _, _ = _preflight(args.config, args.params)
    except Exception as e:
        print(f'analyzer error: {e}', file=sys.stderr)
        return EXIT_ANALYZER_ERROR
    if args.as_json:
        print(_findings_json(findings))
    else:
        print(format_report(findings, with_why=not args.no_why))
    errors, _ = split_findings(findings)
    return EXIT_FINDINGS if errors else EXIT_CLEAN


def cmd_execute(args):
    """Run a DAG in-process without the scheduler (debug mode)."""
    from mlcomp_tpu_torch.db.providers import TaskProvider
    from mlcomp_tpu_torch.worker.storage import link_project_folders
    from mlcomp_tpu_torch.worker.tasks import execute_by_id

    session, dag_row, tasks, cfg = _dag(args.config, args.params,
                                        debug=True)
    provider = TaskProvider(session)
    folder = os.path.dirname(os.path.abspath(args.config)) or '.'
    # debug mode runs tasks in the config folder: give it the data/ and
    # models/ links a downloaded task folder gets
    link_project_folders(folder, cfg['info']['project'])
    # topological order = creation order (the builder creates deps first)
    all_ids = sorted(tid for ids in tasks.values() for tid in ids)
    bad = {int(TaskStatus.Failed), int(TaskStatus.Stopped),
           int(TaskStatus.Skipped)}
    for task_id in all_ids:
        task = provider.by_id(task_id)
        if provider.dependency_status([task_id])[task_id] & bad:
            provider.change_status(task, TaskStatus.Skipped)
            print(f'task {task_id} ({task.name}): skipped '
                  f'(dependency failed)')
            continue
        print(f'task {task_id} ({task.name}): running', flush=True)
        try:
            execute_by_id(task_id, folder=folder, session=session)
            print(f'task {task_id} ({task.name}): success')
        except Exception as e:  # noqa — the row says Failed, go on
            print(f'task {task_id} ({task.name}): FAILED — {e}')
    statuses = {}
    for task_id in all_ids:
        t = provider.by_id(task_id)
        statuses[t.name] = TaskStatus(t.status).name
    print(json.dumps(statuses), flush=True)
    return statuses


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m mlcomp_tpu_torch',
        description='DAG pipelines on the port (PyTorch/CUDA).')
    sub = parser.add_subparsers(dest='command', required=True)
    p = sub.add_parser('init', help='create folders and migrate the DB')
    p.set_defaults(fn=cmd_init)
    p = sub.add_parser('dag', help='submit a DAG')
    p.add_argument('config')
    p.add_argument('--params', action='append', default=[],
                   help='override config values, e.g. --params lr:0.01')
    p.add_argument('--owner', default=None,
                   help='tenant label for the usage ledger '
                        '(overrides info.owner; default "default")')
    p.add_argument('--priority', default=None,
                   choices=['critical', 'high', 'normal', 'preemptible'],
                   help='scheduling class for every task of the dag')
    p.set_defaults(fn=cmd_dag)
    p = sub.add_parser('check', help='static analysis without side effects')
    p.add_argument('config', nargs='?')
    p.add_argument('--code', action='append', default=[],
                   help='lint code trees (not ported yet, ROADMAP.md A8)')
    p.add_argument('--json', dest='as_json', action='store_true',
                   help='machine-readable output (findings + counts)')
    p.add_argument('--params', action='append', default=[],
                   help='overrides to dry-run, e.g. --params lr:0.01')
    p.add_argument('--no-why', action='store_true',
                   help='omit the per-rule rationale lines')
    p.set_defaults(fn=cmd_check)
    p = sub.add_parser('execute',
                       help='run a DAG in-process without the scheduler')
    p.add_argument('config')
    p.add_argument('--params', action='append', default=[])
    p.set_defaults(fn=cmd_execute)
    return parser


def main(argv=None):
    """Run one command; returns its result (``execute``: the statuses).
    A non-zero exit code leaves through ``SystemExit``."""
    args = build_parser().parse_args(argv)
    try:
        result = args.fn(args)
    except CliError as e:
        print(f'Error: {e}', file=sys.stderr)
        raise SystemExit(1)
    if isinstance(result, int) and result:
        raise SystemExit(result)
    return result


if __name__ == '__main__':
    main()

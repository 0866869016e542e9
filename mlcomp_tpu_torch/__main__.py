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
- ``python -m mlcomp_tpu_torch postmortem TASK [--json] [--live]`` — the
  bundle frozen at a task's failure (telemetry/memory.py)
- ``python -m mlcomp_tpu_torch devtime TASK [--tail N] [--json]`` — the
  task's sampled device-time windows (telemetry/deviceprof.py)

``--params a/b:c`` overrides merge into the stored config as the JAX
package's do. The DB is the JAX package's (same root, same schema):
``<root>/db/sqlite.db``. Trainers run on the card; a config asks for the
CPU with ``device: cpu``. The other commands of the JAX package (sync,
alerts, recovery, gangs, supervisors, fleets, sweeps, usage, quotas)
are not ported yet (ROADMAP.md, A0).
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


def _human_bytes(v) -> str:
    for unit, div in (('GB', 1e9), ('MB', 1e6), ('KB', 1e3)):
        if abs(v) >= div:
            return f'{v / div:.2f} {unit}'
    return f'{v:.0f} B'


def cmd_postmortem(args):
    """The flight recorder's bundle for one task (telemetry/memory.py):
    the last steps of the loss / step-time / phase / memory / compile
    series, the run snapshot, the step's memory attribution and the
    alerts, frozen at the failure. Exit 1 when there is none."""
    from mlcomp_tpu_torch.telemetry import build_postmortem, load_postmortem
    session = Session.create_session()
    migrate(session)
    task = args.task
    bundle = build_postmortem(session, task) if args.live \
        else load_postmortem(session, task)
    if bundle is None or (args.live and not bundle.get('task_card')):
        print(f'task {task}: no postmortem recorded (the task never '
              f'failed with a taxonomy reason; --live assembles one from '
              f'current telemetry)')
        return 1
    if args.as_json:
        print(json.dumps(bundle))
        return 0
    card = bundle.get('task_card') or {}
    head = f'task {task}'
    if card.get('name'):
        head += f' ({card["name"]})'
    if bundle.get('reason'):
        head += f' — failed: {bundle["reason"]}'
    if bundle.get('created'):
        head += f' at {bundle["created"]}'
    print(head)
    if card.get('computer'):
        print(f'  on {card["computer"]}'
              + (f', rank {card["rank"]}' if 'rank' in card else ''))
    context = bundle.get('context') or {}
    snapshot = (context.get('run.snapshot') or {}).get('tags') or {}
    if snapshot:
        mesh = snapshot.get('mesh')
        n_params = snapshot.get('n_params')
        print(f'  run: model={snapshot.get("model")}'
              + (f' params={n_params:,}' if n_params is not None else '')
              + (f' mesh={mesh}' if mesh else '')
              + f' batch={snapshot.get("batch_shape")}')
    attribution = (context.get('memory.attribution') or {}).get(
        'tags') or {}
    if attribution:
        parts = [f'{k.replace("_bytes", "")}={_human_bytes(v)}'
                 for k, v in sorted(attribution.items())
                 if isinstance(v, (int, float))]
        print('  compiled peak: ' + ', '.join(parts))
    comm = context.get('comm.bytes_per_step') or {}
    if comm.get('value'):
        print(f'  collectives: {_human_bytes(comm["value"])} per device '
              f'per step')
    series = bundle.get('series') or {}
    for name in sorted(series):
        pts = series[name]
        if not pts:
            continue
        last = pts[-1]
        print(f'  {name}: {len(pts)} samples, last {last["value"]:.6g}'
              + (f' @ step {last["step"]}'
                 if last.get('step') is not None else ''))
    for a in bundle.get('alerts') or []:
        flag = '!' if a.get('severity') == 'critical' else '~'
        print(f'  {flag} [{a.get("rule")}] {a.get("message")}')
    return 0


def cmd_devtime(args):
    """Device-time attribution of one task (telemetry/deviceprof.py):
    where the sampled trace windows say the device's time went —
    compute, exposed collectives, copies, idle — and the host's gaps
    between step dispatches. Exit 1 when nothing was recorded."""
    from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
    session = Session.create_session()
    migrate(session)
    task = args.task
    series = {
        name: rows for name, rows in MetricProvider(session)
        .tail_series(task, per_name=max(1, int(args.tail))).items()
        if name.startswith('devtime.')}
    if not series:
        print(f'task {task}: no device-time attribution recorded (sampled '
              f'profiling is off — telemetry profile_every — and no '
              f'on-demand trace was parsed)')
        return 1
    summary_rows = series.pop('devtime.summary', [])
    newest = summary_rows[-1] if summary_rows else None
    if args.as_json:
        print(json.dumps({'task': task, 'series': series,
                          'summary': newest}))
        return 0
    windows = len(summary_rows) or max(len(rows) for rows in series.values())
    print(f'task {task} — {windows} sampled device-time '
          f'window{"s" if windows != 1 else ""}')
    if newest is not None:
        tags = newest.get('tags') or {}
        buckets = tags.get('buckets') or {}
        head = '  newest window'
        if newest.get('step') is not None:
            head += f' (step {newest["step"]})'
        head += f': {float(newest["value"] or 0):.2f} ms'
        if tags.get('device_lines'):
            head += f' x {tags["device_lines"]} device lines'
        print(head)
        total = sum(float(buckets.get(f'{k}_ms', 0) or 0)
                    for k in ('compute', 'comm_exposed', 'io', 'idle'))
        if total > 0:
            def pct(key):
                return 100 * float(buckets.get(key, 0)) / total
            print(f'    compute {pct("compute_ms"):.1f}%  '
                  f'exposed comm {pct("comm_exposed_ms"):.1f}%  '
                  f'io {pct("io_ms"):.1f}%  '
                  f'idle {pct("idle_ms"):.1f}%  '
                  f'(busy {100 * float(tags.get("busy_frac", 0)):.1f}%)')
        host = tags.get('host') or {}
        if host.get('dispatch_count'):
            print(f'    host dispatch gap '
                  f'{float(host.get("dispatch_gap_ms", 0)):.2f} ms across '
                  f'{host["dispatch_count"]} dispatches')
        ops = tags.get('ops') or []
        if ops:
            print('    top ops: ' + ' | '.join(
                f'{o["op"]} {float(o["ms"]):.2f} ms'
                + (f' x {o["count"]}' if o.get('count') else '')
                for o in ops[:6]))
    trend = series.get('devtime.exposed_comm_frac') or []
    if len(trend) >= 2:
        print('  exposed-comm trend (oldest -> newest): '
              + ' -> '.join(f'{float(p["value"]):.3f}' for p in trend))
    return 0


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
    p = sub.add_parser('postmortem',
                       help="a failed task's frozen postmortem bundle")
    p.add_argument('task', type=int)
    p.add_argument('--json', dest='as_json', action='store_true',
                   help='dump the full bundle as JSON')
    p.add_argument('--live', action='store_true',
                   help='assemble from current telemetry instead of the '
                        'frozen at-failure bundle')
    p.set_defaults(fn=cmd_postmortem)
    p = sub.add_parser('devtime',
                       help="a task's sampled device-time attribution")
    p.add_argument('task', type=int)
    p.add_argument('--tail', type=int, default=16,
                   help='sampled windows of each devtime series to show '
                        '(default: 16)')
    p.add_argument('--json', dest='as_json', action='store_true',
                   help='dump the series tails + newest summary as JSON')
    p.set_defaults(fn=cmd_devtime)
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

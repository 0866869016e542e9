"""JSON server API (port of ``mlcomp_tpu/server/api.py``).

~50 POST endpoints under ``/api/*`` with token auth, an error handler
that heals a wedged DB session, the dashboard page and ``/metrics``, on
stdlib ``http.server.ThreadingHTTPServer``: one process, a thread per
request, sqlite WAL underneath (one session shared by the serving
threads).

Endpoint map (POST JSON unless noted):

- ``/api/token``                    auth check
- ``/api/computers``                machine list + live usage
- ``/api/projects`` + add/edit/remove
- ``/api/layouts`` + layout/add/edit/remove
- ``/api/report/add_start|add_end`` new-report dialog
- ``/api/models``, ``/api/model/remove``
- ``/api/img_classify``, ``/api/img_segment`` galleries
- ``/api/config``, ``/api/graph``, ``/api/dags``
- ``/api/code``, GET ``/api/code_download`` code browser
- ``/api/tasks``, ``/api/task/stop|info|steps``
- ``/api/task/postmortem`` the frozen failure bundle, ``/api/task/devtime``
  the sampled device-time windows (also GET, no auth)
- ``/api/dag/stop|start|remove|preflight|toogle_report`` — ``dag/start``
  is restart-with-resume: Failed/Stopped/Skipped tasks reset to NotRan
  with ``resume{master_computer, master_task_id, load_last}`` attached,
  including distributed-master discovery
- ``/api/auxiliary`` supervisor introspection, no auth
- ``/api/telemetry/series|spans|trace`` (also GET ``/telemetry/series``,
  ``/telemetry/spans``, ``/telemetry/trace/<id>``, no auth)
- ``/api/alerts`` (GET or POST, no auth) + ``/api/alert/resolve`` (auth)
- ``/api/telemetry/profile`` start|stop|status of an on-demand trace
- GET ``/metrics`` (no auth) — OpenMetrics (telemetry/export.py)
- ``/api/logs``, ``/api/reports``, ``/api/report``,
  ``/api/report/update_layout_start|update_layout_end``
- ``/api/remove_imgs``, ``/api/remove_files``
- ``/api/stop``, ``/api/shutdown``
- GET ``/`` and ``/ui``: the dashboard page (server/front.py)

The JAX package's routes whose backing module is not ported yet are in
the table too and refuse with status 501, naming the ROADMAP.md item
they wait for (``WAITING_ROUTES``); the dashboard shows the reason. Auth
is the server token alone: the per-computer worker tokens come with the
server-proxied DB.
"""

import io
import json
import sqlite3
import threading
import traceback
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from mlcomp_tpu_torch import TOKEN, WEB_HOST, WEB_PORT
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.options import PaginatorOptions
from mlcomp_tpu_torch.db.providers import (
    AuxiliaryProvider, ComputerProvider, DagProvider, DagStorageProvider,
    LogProvider, ModelProvider, ProjectProvider,
    ReportImgProvider, ReportLayoutProvider, ReportProvider,
    ReportTasksProvider, StepProvider, TaskProvider
)
from mlcomp_tpu_torch.db.models import Report
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.misc import now, to_snake

_SESSION_KEY = 'server_api'


class ApiError(Exception):
    def __init__(self, message, status=400):
        super().__init__(message)
        self.status = status


def _session():
    """One shared session for the API process — the Session core opens
    sqlite with check_same_thread=False and serializes statements behind
    an RLock, so serving threads can share it (the supervisor and worker
    daemons use the same pattern)."""
    return Session.create_session(key=_SESSION_KEY)


def _heal_session():
    """Drop the shared session and open a fresh one on the same DB (the
    JAX heal path reconnects to the default DB)."""
    connection_string = _session().connection_string
    Session.cleanup(_SESSION_KEY)
    return Session.create_session(key=_SESSION_KEY,
                                  connection_string=connection_string)


def _waits(route: str):
    """The handler of a route whose backing module is not ported yet
    (``WAITING_ROUTES``): it refuses with 501 and the ROADMAP.md item
    it waits for."""
    def handler(data, s):
        raise ApiError(f'{route} is not ported yet (ROADMAP.md, '
                       f'{WAITING_ROUTES[route]})', status=501)
    handler.__name__ = 'api_' + route[len('/api/'):].replace('/', '_')
    return handler


# --------------------------------------------------------------- handlers
# Each handler: (data: dict, session) -> jsonable object (or bytes for
# file downloads). Registered in _ROUTES at the bottom.

def _paginator(data):
    return PaginatorOptions.from_request(data)


def api_token(data, s):
    if str(data.get('token', '')).strip() != TOKEN:
        raise ApiError('invalid token', status=401)
    return {'success': True}


def api_computers(data, s):
    provider = ComputerProvider(s)
    res = provider.get(data, _paginator(data))
    if data.get('usage_history'):
        # per-computer resource history for the UI's sparkline charts
        # (reference db/providers/computer.py:25-99)
        n = int(data.get('usage_history_count', 120))
        for item in res['data']:
            item['usage_history'] = provider.usage_history(
                item['name'], limit=n)['mean']
    return res


def api_projects(data, s):
    return ProjectProvider(s).get(data, _paginator(data))


def api_project_add(data, s):
    ProjectProvider(s).add_project(
        data['name'],
        class_names=yaml_dump(data['class_names'])
        if isinstance(data.get('class_names'), (dict, list))
        else data.get('class_names'),
        ignore_folders=data.get('ignore_folders'))
    return {'success': True}


def api_project_edit(data, s):
    provider = ProjectProvider(s)
    p = provider.by_id(data['id']) if data.get('id') \
        else provider.by_name(data['name'])
    if p is None:
        raise ApiError('project not found', status=404)
    for field in ('name', 'class_names', 'ignore_folders', 'sync_folders'):
        if field in data:
            setattr(p, field, data[field])
    provider.update(p)
    return {'success': True}


def api_project_remove(data, s):
    ProjectProvider(s).remove(data['id'])
    return {'success': True}


def api_layouts(data, s):
    provider = ReportLayoutProvider(s)
    layouts = provider.query('', (), _paginator(data), default_sort='name')
    return {'total': provider.count(),
            'data': [l.to_dict() for l in layouts]}


def api_layout_add(data, s):
    ReportLayoutProvider(s).add_layout(
        data['name'], data.get('content', ''))
    return {'success': True}


def api_layout_edit(data, s):
    ok = ReportLayoutProvider(s).update_layout(
        data['name'], data['content'], new_name=data.get('new_name'))
    if not ok:
        raise ApiError('layout not found', status=404)
    return {'success': True}


def api_layout_remove(data, s):
    provider = ReportLayoutProvider(s)
    layout = provider.by_name(data['name'])
    if layout is not None:
        provider.remove(layout.id)
    return {'success': True}


def api_report_add_start(data, s):
    return {
        'projects': ProjectProvider(s).get()['data'],
        'layouts': list(ReportLayoutProvider(s).all_layouts()),
    }


def api_report_add_end(data, s):
    layouts = ReportLayoutProvider(s)
    resolved = layouts.resolved(data['layout'])
    ReportProvider(s).add(Report(
        name=data['name'], project=data['project'],
        config=yaml_dump(resolved), layout=data['layout'], time=now()))
    return {'success': True}


def api_models(data, s):
    return ModelProvider(s).get(data, _paginator(data))


def api_model_remove(data, s):
    provider = ModelProvider(s)
    m = provider.by_id(data['id']) if data.get('id') \
        else provider.by_name(data['name'])
    if m is not None:
        provider.remove(m.id)
    return {'success': True}


def api_img_classify(data, s):
    provider = ReportImgProvider(s)
    res = provider.get(data, _paginator(data))
    res['confusion'] = provider.confusion_matrix(data)
    return res


def api_img_segment(data, s):
    return ReportImgProvider(s).get(data, _paginator(data))


def api_config(data, s):
    dag_id = data['id'] if isinstance(data, dict) else data
    return {'data': DagProvider(s).config(int(dag_id))}


def api_graph(data, s):
    return DagProvider(s).graph(int(data['id']))


def api_dags(data, s):
    return DagProvider(s).get(data, _paginator(data))


def api_code(data, s):
    """File tree of a DAG's stored code (reference app.py:349-402)."""
    items = DagStorageProvider(s).by_dag(int(data['id']))
    root = {'name': '', 'children': {}, 'content': None, 'id': None}
    for storage, content in items:
        parts = [p for p in storage.path.split('/') if p]
        node = root
        for part in parts[:-1]:
            node = node['children'].setdefault(
                part, {'name': part, 'children': {}, 'content': None,
                       'id': None})
        if not parts:
            continue
        leaf = parts[-1]
        if storage.is_dir:
            node['children'].setdefault(
                leaf, {'name': leaf, 'children': {}, 'content': None,
                       'id': None})
        else:
            text = None
            if content is not None:
                try:
                    text = content.decode() \
                        if isinstance(content, (bytes, bytearray)) \
                        else str(content)
                except UnicodeDecodeError:
                    text = '<binary>'
            node['children'][leaf] = {
                'name': leaf, 'children': {}, 'content': text,
                'id': storage.file}

    def flatten(node):
        children = [flatten(c) for c in node['children'].values()]
        # folders first, then files, each alphabetical (app.py:386-397)
        children.sort(key=lambda x: (0 if x['children'] else 1, x['name']))
        return {'name': node['name'], 'children': children,
                'content': node['content'], 'id': node['id']}

    return {'items': flatten(root)['children']}


def api_code_download(data, s):
    """GET → zip bytes of the DAG's stored code (reference app.py:405-424)."""
    dag_id = int(data['id'])
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, 'w', zipfile.ZIP_DEFLATED) as zf:
        for storage, content in DagStorageProvider(s).by_dag(dag_id):
            if storage.is_dir or content is None:
                continue
            raw = content if isinstance(content, (bytes, bytearray)) \
                else str(content).encode()
            zf.writestr(storage.path, raw)
    return ('application/zip', buf.getvalue(),
            f'attachment; filename=dag_{dag_id}.zip')


def api_tasks(data, s):
    return TaskProvider(s).get(data, _paginator(data))


def _stop_task(s, task):
    from mlcomp_tpu_torch.worker.tasks import kill_task
    kill_task(task.id, session=s)
    provider = TaskProvider(s)
    for child in provider.children(task.id):
        kill_task(child.id, session=s)
    refreshed = provider.by_id(task.id)
    return TaskStatus(refreshed.status)


def api_task_stop(data, s):
    task = TaskProvider(s).by_id(data['id'])
    if task is None:
        raise ApiError('task not found', status=404)
    status = _stop_task(s, task)
    return {'status': to_snake(status.name)}


def api_task_info(data, s):
    provider = TaskProvider(s)
    task = provider.by_id(data['id'])
    if task is None:
        raise ApiError('task not found', status=404)
    info = {
        'id': task.id,
        'pid': task.pid,
        'worker_index': task.worker_index,
        'cores_assigned': task.cores_assigned,
        'queue_id': task.queue_id,
        'additional_info': task.additional_info or '',
        'result': task.result or '',
        # recovery bookkeeping (recovery.py): the dashboard
        # task detail renders these as the retry-history card
        'attempt': task.attempt or 0,
        'max_retries': task.max_retries,
        'next_retry_at': str(task.next_retry_at)
        if task.next_retry_at else None,
        'failure_reason': task.failure_reason,
        # gang bookkeeping (elastic multi-host recovery): identity +
        # generation, and for a gang parent the live rank roster the
        # dashboard gang card renders
        'gang_id': task.gang_id,
        'gang_generation': task.gang_generation or 0,
    }
    if task.gang_id and not task.parent:
        ranks = []
        for child in sorted(provider.children(task.id),
                            key=lambda c: c.id):
            child_info = yaml_load(child.additional_info) \
                if child.additional_info else {}
            distr = (child_info or {}).get('distr_info') or {}
            if not distr:
                continue
            ranks.append({
                'task': child.id,
                'rank': distr.get('process_index'),
                'status': TaskStatus(child.status).name,
                'computer': child.computer_assigned,
                'generation': child.gang_generation or 0,
                'failure_reason': child.failure_reason,
            })
        info['gang_ranks'] = ranks
    return info


def api_task_steps(data, s):
    return {'data': StepProvider(s).get(int(data['id']))}


def api_task_postmortem(data, s):
    """The OOM flight recorder's read surface (telemetry/memory.py):
    the postmortem bundle frozen at the task's failure — last steps of
    the loss/phase/memory/compile series, run snapshot (mesh/batch/
    model), static memory attribution, collective tally, alerts.
    ``{'task': id}`` returns the newest FROZEN bundle (404 when the
    task never failed with a reason); ``{'task': id, 'live': true}``
    assembles one on demand from the current DB rows instead — the
    dashboard's view of a still-running task."""
    from mlcomp_tpu_torch.telemetry import build_postmortem, load_postmortem
    task = _int_arg(data, 'task')
    if task is None:
        task = _int_arg(data, 'id', required=True)
    if TaskProvider(s).by_id(task) is None:
        raise ApiError('task not found', status=404)
    live = data.get('live') in (True, 'true', '1', 1)
    if live:
        bundle = build_postmortem(s, task)
        bundle['live'] = True
        return bundle
    bundle = load_postmortem(s, task)
    if bundle is None:
        raise ApiError(
            'no postmortem recorded for this task (it never failed '
            'with a taxonomy reason); pass live:true to assemble one '
            'from the current telemetry', status=404)
    return bundle


def api_task_devtime(data, s):
    """Device-time attribution (telemetry/deviceprof.py): the sampled
    ``devtime.*`` windows of a task — per-bucket series tails
    (compute / comm / comm_exposed / io / idle ms, busy + exposed-comm
    fractions) plus the newest window's summary (bucket split, top-op
    table, host dispatch gaps). ``{'task': id, 'tail': N}`` bounds the
    series tails (default 32 windows). 404 until a sampled or
    on-demand capture has landed rows."""
    from mlcomp_tpu_torch.db.providers.telemetry import MetricProvider
    task = _int_arg(data, 'task')
    if task is None:
        task = _int_arg(data, 'id', required=True)
    if TaskProvider(s).by_id(task) is None:
        raise ApiError('task not found', status=404)
    tail = _int_arg(data, 'tail')
    series = {
        name: rows for name, rows in
        MetricProvider(s).tail_series(
            task, per_name=max(1, min(tail or 32, 512))).items()
        if name.startswith('devtime.')}
    if not series:
        raise ApiError(
            'no device-time attribution recorded for this task — '
            'sampled profiling is off (telemetry profile_every) and '
            'no on-demand trace has been parsed', status=404)
    summary_rows = series.pop('devtime.summary', [])
    newest = summary_rows[-1] if summary_rows else None
    return {
        'task': task,
        'windows': len(summary_rows) or
        max(len(r) for r in series.values()),
        'series': series,
        'summary': None if newest is None else dict(
            (newest.get('tags') or {}),
            window_ms=newest['value'], step=newest['step'],
            time=newest['time']),
    }


def api_dag_stop(data, s):
    provider = DagProvider(s)
    dag_id = int(data['id'])
    for t in TaskProvider(s).by_dag(dag_id):
        _stop_task(s, t)
    return {'dag': provider.get({'id': dag_id})['data'][0]}


def api_dag_start(data, s):
    """Restart-with-resume (reference app.py:488-552): reset every
    Failed/Stopped/Skipped non-service task to NotRan and attach
    ``resume`` info pointing at the checkpoint's master task. Shares
    ``find_resume_info``/``reset_for_requeue`` with the supervisor's
    automatic retry (recovery.py) — a human restart is the
    same requeue with the attempt counter forgiven and no computer
    excluded. The reset also detaches the previous attempt's finished
    service children, so a restarted distributed master isn't
    instantly re-failed by parent aggregation over stale rows."""
    from mlcomp_tpu_torch.recovery import find_resume_info, reset_for_requeue
    provider = TaskProvider(s)
    dag_id = int(data['id'])
    can_start = {int(TaskStatus.Failed), int(TaskStatus.Skipped),
                 int(TaskStatus.Stopped)}
    restarted = []
    for t in provider.by_dag(dag_id):
        if t.status not in can_start or t.parent:
            continue
        try:
            resume = find_resume_info(provider, t)
        except LookupError:
            raise ApiError('master task not found', status=500)
        reset_for_requeue(provider, t, resume=resume,
                          reset_attempts=True)
        restarted.append(t.id)
    return {'restarted': restarted}


def api_dag_remove(data, s):
    dag_id = int(data['id'])
    for t in TaskProvider(s).by_dag(dag_id):
        _stop_task(s, t)
    DagProvider(s).remove(dag_id)
    return {'success': True}


#: dag id -> live-engine report (errors/warnings dicts). A dag's config
#: + code snapshot are immutable after submit, so the AST re-analysis is
#: the same on every dag-detail view; "stored" rows are NOT cached (the
#: supervisor may append findings later). Bounded FIFO.
_PREFLIGHT_CACHE = {}
_PREFLIGHT_CACHE_MAX = 256


def api_dag_preflight(data, s):
    """Static-analysis report for a DAG (analysis/). Two modes:

    - ``{'id': dag_id}``: run the DAG engine against the STORED config
      + code snapshot (cached — both are immutable after submit), and
      return findings recorded at submit/dispatch time alongside
    - ``{'config': yaml_text}``: preflight a config body that was never
      submitted (dashboard dry-run)
    """
    from mlcomp_tpu_torch.analysis import (
        preflight_config, snapshot_sources, split_findings,
    )
    if data.get('id') is not None:
        dag_id = _int_arg(data, 'id', required=True)
        dag = DagProvider(s).by_id(dag_id)
        if dag is None:
            raise ApiError('dag not found', status=404)
        cached = _PREFLIGHT_CACHE.get(dag_id)
        if cached is None:
            config = yaml_load(dag.config) if dag.config else {}
            findings = preflight_config(
                config, sources=snapshot_sources(s, dag_id))
            errors, warnings = split_findings(findings)
            cached = {'ok': not errors,
                      'errors': [f.to_dict() for f in errors],
                      'warnings': [f.to_dict() for f in warnings]}
            while len(_PREFLIGHT_CACHE) >= _PREFLIGHT_CACHE_MAX:
                _PREFLIGHT_CACHE.pop(next(iter(_PREFLIGHT_CACHE)))
            _PREFLIGHT_CACHE[dag_id] = cached
        from mlcomp_tpu_torch.db.providers import DagPreflightProvider
        stored = [r.to_dict() for r in
                  DagPreflightProvider(s).by_dag(dag_id)]
        return {'dag': dag_id, 'stored': stored, **cached}
    if data.get('config'):
        try:
            config = yaml_load(data['config'])
        except Exception as e:
            raise ApiError(f'config does not parse: {e}')
        errors, warnings = split_findings(preflight_config(config))
        return {
            'dag': None,
            'ok': not errors,
            'errors': [f.to_dict() for f in errors],
            'warnings': [f.to_dict() for f in warnings],
            'stored': [],
        }
    raise ApiError('id or config required')


def api_dag_toggle_report(data, s):
    """Attach/detach every train task of a dag to a report
    (reference app.py:561-572)."""
    from mlcomp_tpu_torch.db.enums import TaskType
    report = int(data['report'])
    dag_id = int(data['id'])
    provider = ReportTasksProvider(s)
    tasks = [t for t in TaskProvider(s).by_dag(dag_id)
             if t.type != int(TaskType.Service)]
    if data.get('remove'):
        for t in tasks:
            provider.remove_task(report, t.id)
    else:
        existing = set(provider.tasks_of(report))
        for t in tasks:
            if t.id not in existing:
                provider.add_task(report, t.id)
    return {'success': True}


def api_task_toggle_report(data, s):
    report = int(data['report'])
    task = int(data['id'])
    provider = ReportTasksProvider(s)
    if data.get('remove'):
        provider.remove_task(report, task)
    elif task not in provider.tasks_of(report):
        provider.add_task(report, task)
    return {'success': True}


def api_auxiliary(data, s):
    out = AuxiliaryProvider(s).get()
    # annotate serving heartbeats with their age by the SERVER clock so
    # the dashboard can apply a liveness window without trusting the
    # client's clock (same pattern as DockerProvider.alive)
    import time as _time
    for name, entry in out.items():
        if name.startswith('serving:') and isinstance(entry, dict) \
                and entry.get('ts'):
            entry['age_s'] = round(_time.time() - float(entry['ts']), 1)
    return out


def _int_arg(data, key, required=False):
    """Parse an integer request arg; bad input is the caller's fault
    (400), not a server error — GET args arrive as strings."""
    value = data.get(key)
    if value is None:
        if required:
            raise ApiError(f'{key} required')
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        raise ApiError(f'{key} must be an integer', status=400)


#: hard ceiling on telemetry page size — a runaway `limit` must not
#: let one anonymous GET materialize the whole metric table
_TELEMETRY_LIMIT_CAP = 100000


def _limit_offset(data, default_limit=_TELEMETRY_LIMIT_CAP):
    """Validated (limit, offset) for the telemetry reads: garbage and
    negatives are the caller's 400 (not raw values handed to the
    provider's SQL), and limit is capped."""
    limit = _int_arg(data, 'limit')
    offset = _int_arg(data, 'offset')
    if limit is None:
        limit = default_limit
    elif limit < 0:
        raise ApiError('limit must be >= 0', status=400)
    if offset is None:
        offset = 0
    elif offset < 0:
        raise ApiError('offset must be >= 0', status=400)
    return min(limit, _TELEMETRY_LIMIT_CAP), offset


def api_telemetry_series(data, s):
    """Metric series recorded from inside the system (telemetry/):
    per-step loss/throughput from the train loop, supervisor tick
    gauges, serving latency summaries. Filter by task / name /
    component; GET and POST serve the same payload. ``tail=N`` (task
    required) returns the NEWEST N samples of every metric name
    instead — the bounded read the dashboard's performance card uses
    (a plain ascending limit truncates the newest samples of
    later-sorting names on long runs)."""
    from mlcomp_tpu_torch.db.providers import MetricProvider
    task = _int_arg(data, 'task')
    provider = MetricProvider(s)
    tail = _int_arg(data, 'tail')
    if tail is not None:
        if tail <= 0:
            raise ApiError('tail must be > 0', status=400)
        if task is None:
            raise ApiError('tail requires task', status=400)
        return {'task': task,
                'series': provider.tail_series(
                    task, per_name=min(tail, 1000))}
    limit, offset = _limit_offset(data)
    return {
        'task': task,
        'series': provider.series(
            task_id=task, name=data.get('name'),
            component=data.get('component'),
            limit=limit, offset=offset),
    }


def api_telemetry_spans(data, s):
    """Span forest of one task: the worker pipeline phases (download,
    executor import, run) with durations — where the wall-clock went."""
    from mlcomp_tpu_torch.db.providers import TelemetrySpanProvider
    task = _int_arg(data, 'task', required=True)
    limit, offset = _limit_offset(data)
    return {'task': task,
            'spans': TelemetrySpanProvider(s).tree(
                task, limit=limit, offset=offset)}


def api_telemetry_trace(data, s):
    """The assembled CROSS-PROCESS trace of one DAG submission:
    supervisor dispatch spans, worker pipeline spans and train-loop
    spans joined by the trace id that rode the queue payload and the
    task environment (telemetry/spans.py). Served at
    ``GET /telemetry/trace/<id>`` and ``POST /api/telemetry/trace``."""
    from mlcomp_tpu_torch.db.providers import TelemetrySpanProvider
    trace_id = data.get('id') or data.get('trace')
    if not trace_id or not isinstance(trace_id, str):
        raise ApiError('trace id required')
    return TelemetrySpanProvider(s).trace_tree(trace_id)


def api_alerts(data, s):
    """Watchdog findings (telemetry/watchdog.py): stalled tasks,
    step-time regressions, stragglers, HBM pressure. Default shows
    OPEN alerts; ``status: all`` includes resolved history. Same
    no-auth introspection tier as /api/auxiliary."""
    from mlcomp_tpu_torch.db.providers import AlertProvider
    status = data.get('status', 'open')
    if status == 'all':
        status = None
    elif status not in (None, 'open', 'resolved'):
        raise ApiError('status must be open|resolved|all', status=400)
    limit, offset = _limit_offset(data, default_limit=200)
    provider = AlertProvider(s)
    rows = provider.get(
        status=status, task=_int_arg(data, 'task'),
        rule=data.get('rule'), limit=max(1, limit), offset=offset)
    return {'data': [provider.serialize(r) for r in rows]}


def api_alert_resolve(data, s):
    """Close an open alert (dashboard/CLI ack). Mutates state — token
    required, unlike the alert reads."""
    from mlcomp_tpu_torch.db.providers import AlertProvider
    alert_id = _int_arg(data, 'id', required=True)
    return {'success': True,
            'resolved': AlertProvider(s).resolve(alert_id)}


def api_telemetry_profile(data, s):
    """Toggle an on-demand ``torch.profiler`` trace on a RUNNING task:
    action start|stop|status (telemetry/profiler.py — the training
    process polls at epoch boundaries). Once the worker stops the
    trace it parses the dump (parse-on-stop), so the ``done`` row
    returned by stop/status carries the device-time ``attribution``
    — buckets, exposed-comm, top ops — not just the trace dir."""
    from mlcomp_tpu_torch.telemetry import (
        request_stop, request_trace, trace_status,
    )
    task = _int_arg(data, 'task', required=True)
    action = data.get('action', 'start')
    if action == 'start':
        max_epochs = _int_arg(data, 'max_epochs')
        row = request_trace(s, task, out_dir=data.get('dir'),
                            max_epochs=1 if max_epochs is None
                            else max_epochs)
    elif action == 'stop':
        row = request_stop(s, task)
    elif action == 'status':
        row = trace_status(s, task)
    else:
        raise ApiError(f'unknown action {action!r} '
                       f'(start|stop|status)')
    return dict(row, task=task)


def api_logs(data, s):
    return LogProvider(s).get(data, _paginator(data))


def api_reports(data, s):
    return ReportProvider(s).get(data, _paginator(data))


def api_report(data, s):
    return ReportProvider(s).detail(int(data['id']))


def api_report_update_layout_start(data, s):
    return ReportProvider(s).update_layout_start(int(data['id']))


def api_report_update_layout_end(data, s):
    ok = ReportProvider(s).update_layout_end(
        int(data['id']), data['layout'])
    if not ok:
        raise ApiError('report not found', status=404)
    return {'success': True}


def api_remove_imgs(data, s):
    ReportImgProvider(s).remove_with_predicate(data)
    return {'success': True}


def api_remove_files(data, s):
    dag_id = data.get('dag')
    if dag_id:
        s.execute('DELETE FROM dag_storage WHERE dag=?', (dag_id,))
        s.execute('DELETE FROM file WHERE dag=?', (dag_id,))
    return {'success': True}


#: routes refused off-host while the shipped default token is in place
_GATED_ROUTES = ('/api/db', '/api/worker_token', '/api/db_audit')


def default_token_gate_blocks(path: str, client_ip: str) -> bool:
    return path in _GATED_ROUTES and TOKEN == 'token' \
        and client_ip not in ('127.0.0.1', '::1')


def api_stop(data, s):
    """Stop the worker daemons of this host (the API/supervisor process
    stays up: /api/shutdown is for that). ``worker start`` group parents
    are terminated FIRST, so their autorestart loop cannot respawn the
    workers killed right after. A ``server start`` parent is left alone:
    its SIGTERM handler would take the API down with it; under that
    deployment the workers it supervises come back, and stopping them
    for good is /api/shutdown or ``mlcomp_tpu_torch.server stop``.
    Processes are found by command line through ``/proc``
    (utils/procfs.py)."""
    import os
    import re
    import signal

    from mlcomp_tpu_torch.utils import procfs
    me = os.getpid()
    group_parent = re.compile(r'mlcomp_tpu_torch\.worker start( |$)')

    def matching(predicate):
        return [pid for pid in procfs.process_pids()
                if pid != me and predicate(procfs.process_cmdline(pid))]

    stopped = []
    for pid in matching(lambda c: bool(group_parent.search(c))) + \
            matching(lambda c: 'mlcomp_tpu_torch.worker' in c):
        try:
            os.kill(pid, signal.SIGTERM)
            stopped.append(pid)
        except (ProcessLookupError, PermissionError):
            pass
    return {'success': True, 'stopped': sorted(set(stopped))}


#: the JAX package's routes whose backing module is not ported yet, with
#: the ROADMAP.md item each waits for
WAITING_ROUTES = {
    '/api/fleets': 'A0: fleets',
    '/api/fleet/create': 'A0: fleets',
    '/api/fleet/scale': 'A0: fleets',
    '/api/fleet/swap': 'A0: fleets',
    '/api/fleet/stop': 'A0: fleets',
    '/api/sweeps': 'A0: ASHA sweeps',
    '/api/usage': 'A0: quotas and usage',
    '/api/slos': 'A0: quotas and usage',
    '/api/quotas': 'A0: quotas and usage',
    '/api/quota/set': 'A0: quotas and usage',
    '/api/quota/delete': 'A0: quotas and usage',
    '/api/model/add': 'A0: the model_add / model_start DAGs',
    '/api/model/start_begin': 'A0: the model_add / model_start DAGs',
    '/api/model/start_end': 'A0: the model_add / model_start DAGs',
    '/api/db': 'A0: the server-proxied DB, with PostgreSQL',
    '/api/worker_token': 'A0: the server-proxied DB, with PostgreSQL',
    '/api/db_audit': 'A0: the server-proxied DB, with PostgreSQL',
}


_ROUTES = {
    '/api/token': (api_token, False),
    '/api/computers': (api_computers, True),
    '/api/projects': (api_projects, True),
    '/api/project/add': (api_project_add, True),
    '/api/project/edit': (api_project_edit, True),
    '/api/project/remove': (api_project_remove, True),
    '/api/layouts': (api_layouts, True),
    '/api/layout/add': (api_layout_add, True),
    '/api/layout/edit': (api_layout_edit, True),
    '/api/layout/remove': (api_layout_remove, True),
    '/api/report/add_start': (api_report_add_start, True),
    '/api/report/add_end': (api_report_add_end, True),
    '/api/models': (api_models, True),
    '/api/model/add': (_waits('/api/model/add'), True),
    '/api/model/remove': (api_model_remove, True),
    '/api/model/start_begin': (_waits('/api/model/start_begin'), True),
    '/api/model/start_end': (_waits('/api/model/start_end'), True),
    '/api/img_classify': (api_img_classify, True),
    '/api/img_segment': (api_img_segment, True),
    '/api/config': (api_config, True),
    '/api/graph': (api_graph, True),
    '/api/dags': (api_dags, True),
    '/api/code': (api_code, True),
    '/api/tasks': (api_tasks, True),
    '/api/task/stop': (api_task_stop, True),
    '/api/task/info': (api_task_info, True),
    '/api/task/steps': (api_task_steps, True),
    # the flight-recorder read is the same no-auth introspection tier
    # as the telemetry series it is assembled from
    '/api/task/postmortem': (api_task_postmortem, False),
    '/api/dag/stop': (api_dag_stop, True),
    '/api/dag/start': (api_dag_start, True),
    '/api/dag/remove': (api_dag_remove, True),
    '/api/dag/preflight': (api_dag_preflight, True),
    '/api/dag/toogle_report': (api_dag_toggle_report, True),
    '/api/task/toogle_report': (api_task_toggle_report, True),
    '/api/auxiliary': (api_auxiliary, False),
    # serving-fleet tier (server/fleet.py): the roster read is the
    # same introspection tier as auxiliary; mutations need the token
    '/api/fleets': (_waits('/api/fleets'), False),
    # ASHA sweep roster (server/sweep.py): read-only audit surface
    '/api/sweeps': (_waits('/api/sweeps'), False),
    # cluster-economy reads (migration v14 + telemetry/slo.py):
    # aggregates + objective verdicts, no secrets — introspection tier
    '/api/usage': (_waits('/api/usage'), False),
    '/api/slos': (_waits('/api/slos'), False),
    # multi-tenant scheduling (migration v15): the roster read is
    # introspection; quota writes change what the scheduler admits
    '/api/quotas': (_waits('/api/quotas'), False),
    '/api/quota/set': (_waits('/api/quota/set'), True),
    '/api/quota/delete': (_waits('/api/quota/delete'), True),
    '/api/fleet/create': (_waits('/api/fleet/create'), True),
    '/api/fleet/scale': (_waits('/api/fleet/scale'), True),
    '/api/fleet/swap': (_waits('/api/fleet/swap'), True),
    '/api/fleet/stop': (_waits('/api/fleet/stop'), True),
    # telemetry reads are an introspection surface like /api/auxiliary
    # (no secrets: metric names + floats); the profile toggle mutates
    # state and needs the token
    '/api/telemetry/series': (api_telemetry_series, False),
    '/api/task/devtime': (api_task_devtime, False),
    '/api/telemetry/spans': (api_telemetry_spans, False),
    '/api/telemetry/trace': (api_telemetry_trace, False),
    '/api/alerts': (api_alerts, False),
    '/api/alert/resolve': (api_alert_resolve, True),
    '/api/telemetry/profile': (api_telemetry_profile, True),
    '/api/logs': (api_logs, True),
    '/api/reports': (api_reports, True),
    '/api/report': (api_report, True),
    '/api/report/update_layout_start': (api_report_update_layout_start, True),
    '/api/report/update_layout_end': (api_report_update_layout_end, True),
    '/api/remove_imgs': (api_remove_imgs, True),
    '/api/remove_files': (api_remove_files, True),
    '/api/stop': (api_stop, True),
    '/api/db': (_waits('/api/db'), True),
    '/api/worker_token': (_waits('/api/worker_token'), True),
    '/api/db_audit': (_waits('/api/db_audit'), True),
}


# routes safe to transparently retry after a mid-request session heal
# (pure reads — no committed statement can be double-applied)
_READ_ONLY_ROUTES = frozenset({
    '/api/token', '/api/computers', '/api/projects', '/api/layouts',
    '/api/report/add_start', '/api/models', '/api/model/start_begin',
    '/api/img_classify', '/api/img_segment', '/api/config', '/api/graph',
    '/api/dags', '/api/code', '/api/tasks', '/api/task/info',
    '/api/task/steps', '/api/dag/preflight', '/api/auxiliary',
    '/api/fleets', '/api/sweeps', '/api/usage', '/api/slos',
    '/api/quotas',
    '/api/logs', '/api/reports',
    '/api/report', '/api/report/update_layout_start',
    '/api/telemetry/series', '/api/telemetry/spans',
    '/api/telemetry/trace', '/api/alerts', '/api/task/postmortem',
    '/api/task/devtime',
})


class ApiHandler(BaseHTTPRequestHandler):
    server_version = 'mlcomp_tpu_torch'
    protocol_version = 'HTTP/1.1'

    # quiet by default; the daemon's logger records errors
    def log_message(self, fmt, *args):  # noqa
        pass

    def _send_json(self, obj, status=200):
        body = json.dumps(obj, default=str).encode()
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.send_header('Access-Control-Allow-Origin', '*')
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(self, content_type, body, disposition=None, status=200):
        self.send_response(status)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        if disposition:
            self.send_header('Content-Disposition', disposition)
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self):
        return self.headers.get('Authorization', '').strip() == TOKEN

    def _dispatch(self, path, data):
        route = _ROUTES.get(path)
        if route is None:
            self._send_json({'success': False, 'reason': 'not found'}, 404)
            return
        handler, needs_auth = route
        if needs_auth and not self._authorized():
            self._send_json(
                {'success': False, 'reason': 'unauthorized'}, 401)
            return
        if default_token_gate_blocks(path, self.client_address[0]):
            # the DB proxy and the credential/audit routes are
            # full-control surfaces; refuse to serve them off-host
            # while the shipped default token is in place
            self._send_json(
                {'success': False,
                 'reason': 'set a real TOKEN in configs/.env before '
                           'multi-computer deployment'}, 403)
            return
        try:
            try:
                res = handler(data, _session())
            except sqlite3.ProgrammingError:
                # another thread healed the shared session mid-request
                # (closed connection). Retry once on the fresh session —
                # but only for read-only routes: a write handler may have
                # already committed its first statements, and re-running
                # it would double-apply them.
                if path not in _READ_ONLY_ROUTES:
                    raise
                res = handler(data, _session())
        except ApiError as e:
            self._send_json(
                {'success': False, 'reason': str(e)}, e.status)
            return
        except Exception as exc:
            # heal-by-recreating-session, but ONLY for DB-level errors
            # (reference app.py:91-131 heals on SQLAlchemyError only —
            # healing on logic errors would close the shared connection
            # under concurrently-serving threads for no reason)
            if isinstance(exc, sqlite3.Error):
                _heal_session()
            err = traceback.format_exc()
            if getattr(self.server, 'logger', None):
                try:
                    self.server.logger.error(
                        f'api {path} failed:\n{err}', ComponentType.API)
                except Exception:
                    pass
            # tracebacks only to authenticated callers (some routes —
            # auxiliary, token — are open)
            reason = err if self._authorized() else 'internal error'
            self._send_json({'success': False, 'reason': reason}, 500)
            return
        if isinstance(res, tuple):  # (content_type, bytes, disposition)
            self._send_bytes(*res)
        else:
            self._send_json(res if res is not None else {'success': True})

    def do_POST(self):  # noqa
        length = int(self.headers.get('Content-Length') or 0)
        raw = self.rfile.read(length) if length else b''
        try:
            data = json.loads(raw) if raw else {}
        except ValueError:
            self._send_json(
                {'success': False, 'reason': 'invalid json'}, 400)
            return
        path = urlparse(self.path).path
        if path == '/api/shutdown':
            # reference app.py:725-730; shutdown() must run off the
            # serving thread or serve_forever deadlocks
            if not self._authorized():
                self._send_json(
                    {'success': False, 'reason': 'unauthorized'}, 401)
                return
            self._send_json({'success': True,
                             'reason': 'server shutting down'})
            threading.Thread(
                target=self.server.shutdown, daemon=True).start()
            return
        self._dispatch(path, data)

    def do_GET(self):  # noqa
        parsed = urlparse(self.path)
        if parsed.path == '/api/code_download':
            qs = parse_qs(parsed.query)
            if not self._authorized() and qs.get('token', [''])[0] != TOKEN:
                self._send_json(
                    {'success': False, 'reason': 'unauthorized'}, 401)
                return
            try:
                res = api_code_download(
                    {'id': qs.get('id', ['0'])[0]}, _session())
                self._send_bytes(*res)
            except Exception as exc:
                if isinstance(exc, sqlite3.Error):
                    _heal_session()
                self._send_json(
                    {'success': False,
                     'reason': traceback.format_exc()}, 500)
            return
        if parsed.path == '/metrics':
            # OpenMetrics export (telemetry/export.py): everything a
            # stock Prometheus scraper needs from a deployment — queue
            # depth, dispatch latency, task counts, slot occupancy,
            # open alerts, step phase attribution, serving latency
            # buckets. Same no-auth introspection tier as the
            # telemetry reads (metric names + floats, no secrets).
            from mlcomp_tpu_torch.telemetry.export import (
                OPENMETRICS_CONTENT_TYPE, render_server_metrics,
            )

            def scrape():
                # probe OUTSIDE the defensive collectors (which
                # swallow everything into mlcomp_scrape_errors): a
                # broken session must RAISE here or the heal/retry
                # below never fires and every later scrape stays empty
                s = _session()
                s.query_one('SELECT 1')
                return render_server_metrics(s)

            try:
                try:
                    body = scrape()
                except sqlite3.ProgrammingError:
                    body = scrape()       # healed mid-request: retry
                self._send_bytes(OPENMETRICS_CONTENT_TYPE,
                                 body.encode())
            except Exception as exc:
                if isinstance(exc, sqlite3.Error):
                    _heal_session()
                self._send_json(
                    {'success': False, 'reason': 'internal error'}, 500)
            return
        if parsed.path in ('/telemetry/series', '/telemetry/spans',
                           '/api/alerts', '/api/fleets', '/api/sweeps',
                           '/api/usage', '/api/slos',
                           '/api/task/postmortem',
                           '/api/task/devtime') \
                or parsed.path.startswith('/telemetry/trace/'):
            # GET mirrors of the POST routes (curl-friendly:
            # /telemetry/series?task=7&name=loss,
            # /telemetry/trace/<id>, /api/alerts?status=all,
            # /api/task/postmortem?task=7); same no-auth introspection
            # tier as /api/auxiliary
            qs = parse_qs(parsed.query)
            data = {k: v[0] for k, v in qs.items()}
            if parsed.path == '/telemetry/series':
                handler = api_telemetry_series
            elif parsed.path == '/telemetry/spans':
                handler = api_telemetry_spans
            elif parsed.path == '/api/alerts':
                handler = api_alerts
            elif parsed.path == '/api/task/postmortem':
                handler = api_task_postmortem
            elif parsed.path == '/api/task/devtime':
                handler = api_task_devtime
            elif parsed.path in WAITING_ROUTES:
                handler = _ROUTES[parsed.path][0]
            else:
                data['id'] = parsed.path[len('/telemetry/trace/'):]
                handler = api_telemetry_trace
            try:
                try:
                    res = handler(data, _session())
                except sqlite3.ProgrammingError:
                    res = handler(data, _session())  # healed mid-read
                self._send_json(res)
            except ApiError as e:
                self._send_json(
                    {'success': False, 'reason': str(e)}, e.status)
            except Exception as exc:
                if isinstance(exc, sqlite3.Error):
                    _heal_session()
                self._send_json(
                    {'success': False, 'reason': 'internal error'}, 500)
            return
        if parsed.path in ('/', '/ui') or parsed.path.startswith('/ui/'):
            from mlcomp_tpu_torch.server.front import dashboard_html
            body = dashboard_html().encode()
            self._send_bytes('text/html; charset=utf-8', body)
            return
        self._send_json({'success': False, 'reason': 'not found'}, 404)


class ApiServer:
    """Threaded HTTP server wrapper with start/stop for tests and the CLI."""

    def __init__(self, host: str = None, port: int = None, logger=None):
        self.host = host if host is not None else WEB_HOST
        self.port = port if port is not None else WEB_PORT
        self.httpd = ThreadingHTTPServer((self.host, self.port), ApiHandler)
        self.httpd.logger = logger
        self.port = self.httpd.server_address[1]  # resolved if port=0
        self._thread = None
        #: the in-process supervisor loops (start_server), stopped with
        #: the server
        self.jobs = []

    def start_background(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        for job in self.jobs:
            job.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        for job in self.jobs:
            job.join(timeout=10)


def start_server(host: str = None, port: int = None, logger=None,
                 with_supervisor: bool = True, background: bool = False,
                 connection_string: str = None):
    """Migrate, optionally start the HA supervisor loop in-process (the
    reference registers it from the Flask process, app.py:736-741), then
    serve the API. ``connection_string`` names another DB than the
    root's (the API's and the supervisor's sessions both open it). With
    ``background`` the server runs on a thread and is returned;
    ``shutdown()`` stops the supervisor too."""
    session = Session.create_session(
        key=_SESSION_KEY, connection_string=connection_string)
    migrate(session)
    jobs = []
    if with_supervisor:
        from mlcomp_tpu_torch.server.supervisor import register_supervisor
        _builder, jobs = register_supervisor(
            session=Session.create_session(
                key='supervisor', connection_string=connection_string),
            logger=logger)
        # graceful supervisor shutdown: SIGTERM releases the leader
        # lease in the SAME tick (SupervisorLoop.stop → explicit lease
        # drop + event publish), so a rolling restart's hot standby
        # promotes in milliseconds instead of waiting out a full lease
        # window. Signal handlers only install from the main thread —
        # a background start_server keeps the expiry backstop.
        import signal as _signal

        def _graceful(_signum, _frame):
            for job in jobs:
                try:
                    job.stop()
                except Exception:
                    pass
            raise SystemExit(0)
        try:
            _signal.signal(_signal.SIGTERM, _graceful)
        except ValueError:
            pass
    server = ApiServer(host=host, port=port, logger=logger)
    server.jobs = jobs
    if background:
        return server.start_background()
    server.serve_forever()
    return server


__all__ = ['ApiServer', 'start_server', 'ApiError', 'WAITING_ROUTES',
           'default_token_gate_blocks']

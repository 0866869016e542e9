"""OpenMetrics export (port of ``mlcomp_tpu/telemetry/export.py``).

Three parts:

- ``render_openmetrics(families)`` — family dicts → the wire text
  (``# TYPE``/``# HELP`` headers, label-escaped samples, the
  mandatory ``# EOF`` trailer); ``GET /metrics`` on a serving process
  (server/serve.py) and on the API server (server/api.py) return it;
- ``parse_openmetrics(text)`` — a minimal validating line parser, for
  the tests and the chip smoke;
- ``collect_server_families(session)`` — the API server's collector:
  each family reads the DB defensively (a failing collector yields an
  empty family plus a ``mlcomp_scrape_errors`` count, never a 500 —
  a monitoring endpoint that dies when the system is sick is useless
  exactly when it matters).

A JAX family that reads through a module the port lacks is not
collected (``WAITING_FAMILIES`` names each with the ROADMAP.md item that
brings it; none at present); every other family is the JAX package's.
"""

import json
import re
import time

#: the content type Prometheus negotiates for OpenMetrics 1.0
OPENMETRICS_CONTENT_TYPE = \
    'application/openmetrics-text; version=1.0.0; charset=utf-8'

#: the JAX package's families that read through a module the port does
#: not have yet, with the ROADMAP.md item (A0) that brings each
WAITING_FAMILIES = {}

#: families GET /metrics always declares (headers render even with no
#: samples); the tests assert this cover
REQUIRED_FAMILIES = (
    'mlcomp_up', 'mlcomp_tasks', 'mlcomp_queue_depth',
    'mlcomp_worker_slots', 'mlcomp_alerts_open',
    'mlcomp_dispatch_latency_seconds', 'mlcomp_step_phase_ms',
    'mlcomp_pipeline_efficiency', 'mlcomp_compile_events',
    'mlcomp_task_retries', 'mlcomp_db_busy_retries',
    'mlcomp_gang_generations',
    'mlcomp_serving_latency_ms',
    'mlcomp_fleet_replicas', 'mlcomp_fleet_generation',
    'mlcomp_fleet_shed', 'mlcomp_fleet_respawns',
    'mlcomp_fleet_swaps',
    'mlcomp_sweep_cells', 'mlcomp_sweep_prunes', 'mlcomp_sweep_rung',
    'mlcomp_hbm_bytes', 'mlcomp_comm_bytes', 'mlcomp_comm_fraction',
    'mlcomp_devtime_ms', 'mlcomp_devtime_exposed_comm_fraction',
    'mlcomp_supervisor_leader', 'mlcomp_supervisor_epoch',
    'mlcomp_supervisor_failovers', 'mlcomp_supervisor_fenced_writes',
    'mlcomp_db_listener_reconnects',
    'mlcomp_usage_core_seconds', 'mlcomp_usage_tasks',
    'mlcomp_queue_wait_seconds', 'mlcomp_queue_max_wait_seconds',
    'mlcomp_preemptions', 'mlcomp_quota_usage',
    'mlcomp_slo_bad_fraction', 'mlcomp_slo_burn_rate',
    'mlcomp_scrape_errors', 'mlcomp_scrape_duration_seconds',
)


# ---------------------------------------------------------------- render
def _escape_label(value) -> str:
    return str(value).replace('\\', r'\\').replace('"', r'\"') \
        .replace('\n', r'\n')


def _format_value(value) -> str:
    if value is None:
        return 'NaN'
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def family(name, mtype, help_text, samples=None):
    """One metric family. ``samples``: ``[(suffix, labels, value)]`` —
    suffix '' for plain gauges, '_total'/'_bucket'/'_count'/'_sum' for
    counter/histogram/summary parts."""
    return {'name': name, 'type': mtype, 'help': help_text,
            'samples': list(samples or [])}


def render_openmetrics(families) -> str:
    out = []
    for fam in families:
        name = fam['name']
        out.append(f'# TYPE {name} {fam["type"]}')
        if fam.get('help'):
            out.append(f'# HELP {name} {fam["help"]}')
        for suffix, labels, value in fam['samples']:
            label_str = ''
            if labels:
                inner = ','.join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in labels.items())
                label_str = '{' + inner + '}'
            out.append(
                f'{name}{suffix}{label_str} {_format_value(value)}')
    out.append('# EOF')
    return '\n'.join(out) + '\n'


# ----------------------------------------------------------------- parse
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'       # metric name
    r'(?:\{(.*)\})?'                     # optional label block
    r'\s+(\S+)'                          # value
    r'(?:\s+(\S+))?$')                   # optional timestamp
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
#: sample-name suffixes that still belong to the declaring family
_FAMILY_SUFFIXES = ('_total', '_bucket', '_count', '_sum', '_created')


def _unescape_label(value: str) -> str:
    # one left-to-right scan — chained str.replace would decode the
    # 'n' of a literal backslash-escaped '\\n' as a newline
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == '\\' and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == 'n':
                out.append('\n')
                i += 2
                continue
            if nxt in ('\\', '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return ''.join(out)


def _parse_labels(blob: str, lineno: int) -> dict:
    """Strict sequential parse of a label blob — findall would
    silently skip malformed segments (`{le=+Inf}` parsing as zero
    labels), and this parser exists to REJECT what a real scraper
    would reject."""
    labels = {}
    i = 0
    while i < len(blob):
        m = _LABEL_RE.match(blob, i)
        if m is None:
            raise ValueError(
                f'line {lineno}: malformed label block: {blob!r}')
        labels[m.group(1)] = _unescape_label(m.group(2))
        i = m.end()
        if i < len(blob):
            if blob[i] != ',':
                raise ValueError(
                    f'line {lineno}: malformed label block: {blob!r}')
            i += 1
            while i < len(blob) and blob[i] == ' ':
                i += 1
    return labels


def _family_of(sample_name: str, declared) -> str:
    if sample_name in declared:
        return sample_name
    for suffix in _FAMILY_SUFFIXES:
        if sample_name.endswith(suffix) and \
                sample_name[:-len(suffix)] in declared:
            return sample_name[:-len(suffix)]
    raise ValueError(
        f'sample {sample_name!r} references no declared family')


def parse_openmetrics(text: str) -> dict:
    """Validate + parse an OpenMetrics payload into
    ``{family: {'type', 'help', 'samples': [(name, labels, value)]}}``.
    Raises ``ValueError`` on: a missing ``# EOF`` trailer, a sample
    whose family was never declared (``# TYPE``), an unparsable value,
    a malformed label block, or a line that is neither comment, blank,
    nor sample."""
    declared = {}
    lines = text.split('\n')
    saw_eof = False
    for lineno, line in enumerate(lines, 1):
        line = line.rstrip('\r')
        if saw_eof and line.strip():
            raise ValueError(f'line {lineno}: content after # EOF')
        if not line.strip():
            continue
        if line == '# EOF':
            saw_eof = True
            continue
        if line.startswith('# TYPE '):
            parts = line.split(' ', 3)
            if len(parts) < 4:
                raise ValueError(f'line {lineno}: malformed TYPE')
            declared[parts[2]] = {'type': parts[3], 'help': None,
                                  'samples': []}
            continue
        if line.startswith('# HELP '):
            parts = line.split(' ', 3)
            if len(parts) < 3:
                raise ValueError(f'line {lineno}: malformed HELP')
            fam = declared.get(parts[2])
            if fam is not None:
                fam['help'] = parts[3] if len(parts) > 3 else ''
            continue
        if line.startswith('#'):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f'line {lineno}: unparsable: {line!r}')
        sample_name, label_blob, raw_value, _ts = m.groups()
        fam_name = _family_of(sample_name, declared)
        labels = _parse_labels(label_blob or '', lineno)
        try:
            value = float(raw_value)
        except ValueError:
            if raw_value not in ('NaN', '+Inf', '-Inf'):
                raise ValueError(
                    f'line {lineno}: bad value {raw_value!r}')
            value = float(raw_value.replace('Inf', 'inf'))
        declared[fam_name]['samples'].append(
            (sample_name, labels, value))
    if not saw_eof:
        raise ValueError('payload does not end with # EOF')
    return declared


# --------------------------------------------------- server-side collect
def _collect_tasks(session, samples):
    from mlcomp_tpu_torch.db.enums import TaskStatus
    from mlcomp_tpu_torch.utils.misc import to_snake
    counts = {int(s): 0 for s in TaskStatus}
    for r in session.query(
            'SELECT status, COUNT(*) AS n FROM task GROUP BY status'):
        if r['status'] in counts:
            counts[r['status']] = r['n']
    for status, n in counts.items():
        samples.append(
            ('', {'status': to_snake(TaskStatus(status).name)}, n))


def _collect_queue_depth(session, samples):
    for r in session.query(
            "SELECT queue, COUNT(*) AS n FROM queue_message "
            "WHERE status='pending' GROUP BY queue"):
        samples.append(('', {'queue': r['queue']}, r['n']))


def _collect_worker_slots(session, samples):
    from mlcomp_tpu_torch.db.enums import TaskStatus
    busy = {}
    for r in session.query(
            'SELECT computer_assigned, cores_assigned FROM task '
            'WHERE status IN (?, ?) AND computer_assigned IS NOT NULL',
            (int(TaskStatus.Queued), int(TaskStatus.InProgress))):
        try:
            n = len(json.loads(r['cores_assigned'] or '[]'))
        except (TypeError, ValueError):
            n = 0
        busy[r['computer_assigned']] = \
            busy.get(r['computer_assigned'], 0) + n
    for r in session.query('SELECT name, cores FROM computer'):
        samples.append(('', {'computer': r['name'], 'state': 'total'},
                        r['cores'] or 0))
        samples.append(('', {'computer': r['name'], 'state': 'busy'},
                        busy.get(r['name'], 0)))


def _collect_alerts(session, samples):
    for r in session.query(
            "SELECT rule, severity, COUNT(*) AS n FROM alert "
            "WHERE status='open' GROUP BY rule, severity"):
        samples.append(('', {'rule': r['rule'],
                             'severity': r['severity'] or 'warning'},
                        r['n']))


def _latest_metric(session, name, component=None):
    sql = 'SELECT value FROM metric WHERE name=?'
    params = [name]
    if component:
        sql += ' AND component=?'
        params.append(component)
    row = session.query_one(sql + ' ORDER BY id DESC LIMIT 1',
                            tuple(params))
    return row['value'] if row else None


def _collect_dispatch_latency(session, samples):
    # the supervisor's enqueue→claim histogram summaries (seconds),
    # re-shaped as an OpenMetrics summary: latest row per stat.
    # Quantiles ONLY — the source histogram resets every supervisor
    # flush window, so a _count/_sum derived from it would DECREASE
    # between scrapes and Prometheus would misread every dip as a
    # counter reset (quantile-only summaries are valid OpenMetrics)
    base = 'supervisor.dispatch_latency_s'
    p50 = _latest_metric(session, f'{base}.p50', 'supervisor')
    p99 = _latest_metric(session, f'{base}.p99', 'supervisor')
    if p50 is not None:
        samples.append(('', {'quantile': '0.5'}, p50))
    if p99 is not None:
        samples.append(('', {'quantile': '0.99'}, p99))


#: per-task families cover the newest this-many running tasks — a
#: bound so one scrape can't fan out per-task queries without limit.
#: Documented in the family help; the total running count
#: (mlcomp_tasks{status="in_progress"}) is always exact, so a scraper
#: can SEE when the per-task detail is truncated.
_RUNNING_TASKS_CAP = 256


def _running_task_ids(session, limit=_RUNNING_TASKS_CAP):
    from mlcomp_tpu_torch.db.enums import TaskStatus
    return [r['id'] for r in session.query(
        'SELECT id FROM task WHERE status=? ORDER BY id DESC LIMIT ?',
        (int(TaskStatus.InProgress), int(limit)))]


def _collect_step_phases(session, running, phase_samples, eff_samples):
    from mlcomp_tpu_torch.telemetry.attribution import PHASES
    if not running:
        return
    names = [f'step.phase.{p}_ms' for p in PHASES] \
        + ['step.pipeline_efficiency']
    marks = ','.join('?' * len(running))
    name_marks = ','.join('?' * len(names))
    # bare `value` rides the MAX(id) row (documented sqlite behavior):
    # one query yields the LATEST sample per (task, name)
    for r in session.query(
            f'SELECT task, name, value, MAX(id) AS latest FROM metric '
            f'WHERE task IN ({marks}) AND name IN ({name_marks}) '
            f'GROUP BY task, name',
            tuple(running) + tuple(names)):
        if r['name'] == 'step.pipeline_efficiency':
            eff_samples.append(('', {'task': r['task']}, r['value']))
        else:
            phase = r['name'][len('step.phase.'):-len('_ms')]
            phase_samples.append(
                ('', {'task': r['task'], 'phase': phase}, r['value']))


#: device timeline names: device<N>.hbm_<kind>
_HBM_NAME = re.compile(r'^device(\d+)\.hbm_(used|limit|peak)$')
#: per-op collective tallies: comm.<op>_bytes (telemetry/collectives.py)
_COMM_NAME = re.compile(r'^comm\.([a-z_]+)_bytes$')


def _collect_hbm(session, running, samples):
    """``mlcomp_hbm_bytes{task,device,kind=used|limit|peak}`` — the
    latest point of each running task's HBM timeline
    (telemetry/memory.py MemorySampler). A scraper alerting on
    used/limit sees the same occupancy the watchdog's OOM predictor
    regresses over."""
    if not running:
        return
    marks = ','.join('?' * len(running))
    for r in session.query(
            f'SELECT task, name, value, MAX(id) AS latest FROM metric '
            f"WHERE task IN ({marks}) AND name LIKE 'device%.hbm\\_%' "
            f"ESCAPE '\\' GROUP BY task, name", tuple(running)):
        m = _HBM_NAME.match(r['name'])
        if m is None:
            continue
        samples.append(('', {'task': r['task'], 'device': m.group(1),
                             'kind': m.group(2)}, r['value']))


def _collect_comm(session, running, bytes_samples, frac_samples):
    """``mlcomp_comm_bytes{task,op}`` (per-device bytes per step from
    the compiled HLO walk) + ``mlcomp_comm_fraction{task}`` (measured
    wire share of the step) — telemetry/collectives.py. Latest row per
    (task, name) like the step-phase family."""
    if not running:
        return
    marks = ','.join('?' * len(running))
    for r in session.query(
            f'SELECT task, name, value, MAX(id) AS latest FROM metric '
            f"WHERE task IN ({marks}) AND name LIKE 'comm.%' "
            f'GROUP BY task, name', tuple(running)):
        if r['name'] == 'comm.fraction':
            frac_samples.append(('', {'task': r['task']}, r['value']))
            continue
        m = _COMM_NAME.match(r['name'])
        if m is None:
            continue        # counts/probe/totals ride the JSON surfaces
        bytes_samples.append(
            ('', {'task': r['task'], 'op': m.group(1)}, r['value']))


#: devtime bucket series -> the ``bucket`` label value on
#: mlcomp_devtime_ms (telemetry/deviceprof.py BUCKET_SERIES)
_DEVTIME_NAME = re.compile(r'^devtime\.([a-z_]+)_ms$')


def _collect_devtime(session, running, ms_samples, frac_samples):
    """``mlcomp_devtime_ms{task,bucket}`` (newest sampled window's
    compute/comm/comm_exposed/io/idle device time, summed across
    device lines) + ``mlcomp_devtime_exposed_comm_fraction{task}``
    (collective time NOT hidden under compute) —
    telemetry/deviceprof.py sampled profiling. Latest row per
    (task, name) like the comm family."""
    if not running:
        return
    marks = ','.join('?' * len(running))
    for r in session.query(
            f'SELECT task, name, value, MAX(id) AS latest FROM metric '
            f"WHERE task IN ({marks}) AND name LIKE 'devtime.%' "
            f'GROUP BY task, name', tuple(running)):
        if r['name'] == 'devtime.exposed_comm_frac':
            frac_samples.append(('', {'task': r['task']}, r['value']))
            continue
        m = _DEVTIME_NAME.match(r['name'])
        if m is None or m.group(1) in ('window', 'host_dispatch_gap'):
            continue     # fractions/window/summary ride the JSON API
        ms_samples.append(
            ('', {'task': r['task'], 'bucket': m.group(1)},
             r['value']))


def _collect_compile_events(session, running, samples):
    if not running:
        return
    marks = ','.join('?' * len(running))
    for r in session.query(
            f'SELECT task, COUNT(*) AS n FROM metric '
            f"WHERE task IN ({marks}) AND name='compile.backend_ms' "
            f'GROUP BY task', tuple(running)):
        samples.append(('_total', {'task': r['task']}, r['n']))


#: rows scanned per scrape for the retry counter: task.retry rows are
#: written by the supervisor on each automatic retry (one per event),
#: so the newest window covers every live deployment's recent history
#: without an unbounded name scan over the metric table
_RETRY_SCAN_WINDOW = 100000


def _collect_task_retries(session, samples):
    """``mlcomp_task_retries_total{task,reason}`` from the per-event
    ``task.retry`` metric rows (supervisor retry_task). Counter
    semantics hold scrape-over-scrape as long as the events stay
    inside the id window — beyond it the count would dip, which
    Prometheus reads as a counter reset and absorbs."""
    counts = {}
    for r in session.query(
            "SELECT task, tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name='task.retry'", (_RETRY_SCAN_WINDOW,)):
        reason = 'unknown'
        try:
            reason = json.loads(r['tags'] or '{}').get('reason') \
                or 'unknown'
        except ValueError:
            pass
        key = (r['task'], reason)
        counts[key] = counts.get(key, 0) + 1
    for (task, reason), n in sorted(counts.items(),
                                    key=lambda kv: (str(kv[0][0]),
                                                    kv[0][1])):
        samples.append(('_total', {'task': task, 'reason': reason}, n))


def _collect_db_busy(session, samples):
    """``mlcomp_db_busy_retries_total{kind=retry|gave_up}`` — control-
    plane lock pressure, no longer silent. Summed from the
    ``db.busy_retries``/``db.busy_gave_up`` delta rows alone: the
    supervisor samples its own process per tick (the shipped server
    runs the supervisor in-process, so the API server's contention is
    already in the series) and the host agent flushes its process in
    the usage loop — adding THIS process's live counters on top would
    double-count everything those samplers flushed."""
    totals = {'retry': 0.0, 'gave_up': 0.0}
    for r in session.query(
            "SELECT name, SUM(value) AS total FROM metric "
            "WHERE name IN ('db.busy_retries', 'db.busy_gave_up') "
            "GROUP BY name"):
        kind = 'retry' if r['name'] == 'db.busy_retries' else 'gave_up'
        totals[kind] += float(r['total'] or 0)
    for kind in ('retry', 'gave_up'):
        samples.append(('_total', {'kind': kind}, totals[kind]))


def _collect_gang_generations(session, samples):
    """``mlcomp_gang_generations_total{gang,reason}`` from the
    per-event ``gang.generation`` metric rows the supervisor writes at
    each gang-atomic requeue (retry_task). One sample per (gang,
    reason) counting bump EVENTS — same windowed id scan and counter
    semantics as the task-retry family above."""
    counts = {}
    for r in session.query(
            "SELECT tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name='gang.generation'", (_RETRY_SCAN_WINDOW,)):
        gang, reason = 'unknown', 'unknown'
        try:
            tags = json.loads(r['tags'] or '{}')
            gang = tags.get('gang') or 'unknown'
            reason = tags.get('reason') or 'unknown'
        except ValueError:
            pass
        key = (gang, reason)
        counts[key] = counts.get(key, 0) + 1
    for (gang, reason), n in sorted(counts.items()):
        samples.append(('_total', {'gang': gang, 'reason': reason}, n))


#: rows scanned per scrape for the serving re-export: the latest
#: heartbeat's bucket/count/mean rows live at the table's tail, so a
#: bounded id window keeps the scrape O(window) however old the
#: deployment gets. Snapshots older than the window simply drop out of
#: the family (the serving process's own /metrics stays authoritative).
_SERVING_SCAN_WINDOW = 100000


def _collect_serving_latency(session, samples):
    """Latest flushed bucket/count/mean rows per served model → one
    OpenMetrics histogram family. The serving recorder's bucketed
    histograms are CUMULATIVE across flushes (telemetry/metrics.py),
    so the latest snapshot is monotone scrape-over-scrape — real
    Prometheus histogram semantics, same as the serving process's own
    /metrics."""
    pattern = re.compile(
        r'^serving\.(.+)\.latency_ms\.(bucket|count|mean)$')
    latest = {}      # (model, stat, le) -> (id, value)
    for r in session.query(
            "SELECT id, name, value, tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND kind='histogram' AND ("
            "name LIKE 'serving.%.latency_ms.bucket' OR "
            "name LIKE 'serving.%.latency_ms.count' OR "
            "name LIKE 'serving.%.latency_ms.mean')",
            (_SERVING_SCAN_WINDOW,)):
        m = pattern.match(r['name'])
        if m is None:
            continue
        model, stat = m.group(1), m.group(2)
        le = None
        if stat == 'bucket':
            try:
                le = json.loads(r['tags'] or '{}').get('le')
            except ValueError:
                continue
            if le is None:
                continue
        key = (model, stat, str(le))
        if key not in latest or r['id'] > latest[key][0]:
            latest[key] = (r['id'], r['value'])
    models = sorted({model for model, _, _ in latest})
    for model in models:
        buckets = sorted(
            ((le, v) for (m2, stat, le), (_, v) in latest.items()
             if m2 == model and stat == 'bucket'),
            key=lambda kv: float('inf') if kv[0] == '+Inf'
            else float(kv[0]))
        for le, value in buckets:
            samples.append(('_bucket', {'model': model, 'le': le},
                            value))
        count = latest.get((model, 'count', 'None'))
        if count is not None:
            samples.append(('_count', {'model': model}, count[1]))
            mean = latest.get((model, 'mean', 'None'))
            if mean is not None:
                samples.append(('_sum', {'model': model},
                                mean[1] * count[1]))


def _collect_fleet_replicas(session, samples):
    """``mlcomp_fleet_replicas{fleet,state}`` — the replica-pool
    roster the reconciler maintains (db/models/fleet.py). Dead rows
    stay counted: a fleet whose dead count climbs while healthy holds
    at desired is healing correctly; one whose healthy count drops is
    not — both readable from the same gauge."""
    from mlcomp_tpu_torch.db.providers.fleet import ReplicaProvider
    for fleet, states in sorted(
            ReplicaProvider(session).states_by_fleet().items()):
        for state, n in sorted(states.items()):
            samples.append(('', {'fleet': fleet, 'state': state}, n))


def _collect_fleet_generations(session, samples):
    for r in session.query(
            "SELECT name, generation FROM serve_fleet "
            "WHERE status != 'stopped'"):
        samples.append(('', {'fleet': r['name']}, r['generation'] or 0))


def _collect_fleet_shed(session, samples):
    """``mlcomp_fleet_shed_total{fleet}`` from the gateway's flushed
    cumulative gauge rows (``fleet.<name>.shed_cum``) — latest row per
    fleet; cumulative at the source, so counter semantics hold."""
    pattern = re.compile(r'^fleet\.(.+)\.shed_cum$')
    latest = {}
    for r in session.query(
            "SELECT id, name, value FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name LIKE 'fleet.%.shed_cum'", (_SERVING_SCAN_WINDOW,)):
        m = pattern.match(r['name'])
        if m is None:
            continue
        key = m.group(1)
        if key not in latest or r['id'] > latest[key][0]:
            latest[key] = (r['id'], r['value'])
    for fleet, (_, value) in sorted(latest.items()):
        samples.append(('_total', {'fleet': fleet}, value))


def _collect_fleet_events(session, respawns, swaps):
    """``mlcomp_fleet_respawns_total{fleet,reason}`` +
    ``mlcomp_fleet_swaps_total{fleet,outcome}`` from the reconciler's
    per-event metric rows — same windowed id scan and counter
    semantics as the task-retry family."""
    r_counts, s_counts = {}, {}
    for r in session.query(
            "SELECT name, tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name IN ('fleet.respawn', 'fleet.swap')",
            (_RETRY_SCAN_WINDOW,)):
        try:
            tags = json.loads(r['tags'] or '{}')
        except ValueError:
            continue
        fleet = tags.get('fleet') or 'unknown'
        if r['name'] == 'fleet.respawn':
            key = (fleet, tags.get('reason') or 'unknown')
            r_counts[key] = r_counts.get(key, 0) + 1
        else:
            key = (fleet, tags.get('outcome') or 'unknown')
            s_counts[key] = s_counts.get(key, 0) + 1
    for (fleet, reason), n in sorted(r_counts.items()):
        respawns.append(('_total', {'fleet': fleet, 'reason': reason},
                         n))
    for (fleet, outcome), n in sorted(s_counts.items()):
        swaps.append(('_total', {'fleet': fleet, 'outcome': outcome},
                      n))


def _collect_sweeps(session, cells, prunes, rungs):
    """ASHA sweep families (server/sweep.py, migration v13):

    - ``mlcomp_sweep_cells{sweep,state}`` — the cell roster folded
      from task rows: waiting/queued/running plus the terminal split
      the sweep exists to create (``pruned`` = Failed with the
      ``sweep-pruned`` verdict, ``finished`` = Success, ``failed`` =
      everything else terminal);
    - ``mlcomp_sweep_prunes_total{sweep,rung}`` — prune verdicts per
      rung straight off the ``sweep_decision`` audit table (durable:
      counter semantics survive restarts because the decisions do);
    - ``mlcomp_sweep_rung{sweep}`` — the highest rung judged so far
      (-1 until the first verdict): the sweep's ladder position."""
    from mlcomp_tpu_torch.db.enums import TaskStatus
    sweeps = {r['id']: r['name'] for r in session.query(
        'SELECT id, name FROM sweep')}
    if not sweeps:
        return
    # label sets are keyed by the sweep ID (name rides along for
    # humans): sweep names repeat across resubmissions of the same
    # config, and duplicate labelsets would fail the whole scrape
    def labels(sweep_id, **extra):
        return {'sweep': sweeps[sweep_id], 'id': str(sweep_id),
                **extra}
    state_of = {
        int(TaskStatus.NotRan): 'waiting',
        int(TaskStatus.Queued): 'queued',
        int(TaskStatus.InProgress): 'running',
        int(TaskStatus.Success): 'finished',
    }
    counts = {}     # (sweep id, state) -> n
    for r in session.query(
            'SELECT s.id AS sid, t.status AS status, '
            "SUM(CASE WHEN t.failure_reason='sweep-pruned' "
            'THEN 1 ELSE 0 END) AS pruned, COUNT(*) AS n '
            'FROM sweep s JOIN task t '
            'ON t.dag = s.dag AND t.executor = s.executor '
            'WHERE t.parent IS NULL GROUP BY s.id, t.status'):
        state = state_of.get(r['status'], 'failed')
        pruned = r['pruned'] or 0
        rest = r['n'] - (pruned if state == 'failed' else 0)
        if state == 'failed' and pruned:
            key = (r['sid'], 'pruned')
            counts[key] = counts.get(key, 0) + pruned
        if rest:
            key = (r['sid'], state)
            counts[key] = counts.get(key, 0) + rest
    for (sid, state), n in sorted(counts.items()):
        cells.append(('', labels(sid, state=state), n))
    top_rung = {}
    for r in session.query(
            'SELECT d.sweep AS sweep, d.rung AS rung, d.verdict AS v, '
            'COUNT(*) AS n FROM sweep_decision d '
            'GROUP BY d.sweep, d.rung, d.verdict'):
        if r['sweep'] not in sweeps:
            continue
        top_rung[r['sweep']] = max(top_rung.get(r['sweep'], -1),
                                   r['rung'])
        if r['v'] == 'prune':
            prunes.append(('_total',
                           labels(r['sweep'], rung=str(r['rung'])),
                           r['n']))
    for sid in sorted(sweeps):
        rungs.append(('', labels(sid), top_rung.get(sid, -1)))


def _collect_usage(session, core_samples, task_samples):
    """Usage-ledger tenant totals (migration v14): core-seconds and
    folded attempts per (owner, project). The ledger is append-only
    (one exactly-once row per terminal attempt), so both families hold
    counter semantics scrape-over-scrape without any event window."""
    for r in session.query(
            'SELECT owner, project, COUNT(*) AS n, '
            'SUM(core_seconds) AS cs FROM usage '
            'GROUP BY owner, project ORDER BY owner, project'):
        labels = {'owner': r['owner'] or 'default',
                  'project': r['project'] or 'default'}
        core_samples.append(('_total', labels, float(r['cs'] or 0.0)))
        task_samples.append(('_total', labels, r['n']))


def _collect_queue_wait(session, samples):
    """Latest flushed bucket/count/mean rows per scheduling class →
    one histogram family (``mlcomp_queue_wait_seconds{class,
    priority}``). Series names are ``queue.wait_s.<class>.<priority>``
    since migration v15; a legacy class-only series (no priority
    segment) exports with priority='normal'. The supervisor's
    queue-wait recorder uses cumulative buckets
    (telemetry/metrics.py), so the latest snapshot is monotone — same
    protocol as the serving-latency re-export."""
    from mlcomp_tpu_torch.server.scheduler import PRIORITY_RANK
    pattern = re.compile(
        r'^queue\.wait_s\.(.+)\.(bucket|count|mean)$')
    latest = {}      # ((class, priority), stat, le) -> (id, value)
    for r in session.query(
            "SELECT id, name, value, tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND kind='histogram' AND ("
            "name LIKE 'queue.wait_s.%.bucket' OR "
            "name LIKE 'queue.wait_s.%.count' OR "
            "name LIKE 'queue.wait_s.%.mean')",
            (_SERVING_SCAN_WINDOW,)):
        m = pattern.match(r['name'])
        if m is None:
            continue
        series, stat = m.group(1), m.group(2)
        head, _, tail = series.rpartition('.')
        if head and tail in PRIORITY_RANK:
            cls, prio = head, tail
        else:
            cls, prio = series, 'normal'
        le = None
        if stat == 'bucket':
            try:
                le = json.loads(r['tags'] or '{}').get('le')
            except ValueError:
                continue
            if le is None:
                continue
        key = ((cls, prio), stat, str(le))
        if key not in latest or r['id'] > latest[key][0]:
            latest[key] = (r['id'], r['value'])
    pairs = sorted({pair for pair, _, _ in latest})
    for pair in pairs:
        cls, prio = pair
        labels = {'class': cls, 'priority': prio}
        buckets = sorted(
            ((le, v) for (p2, stat, le), (_, v) in latest.items()
             if p2 == pair and stat == 'bucket'),
            key=lambda kv: float('inf') if kv[0] == '+Inf'
            else float(kv[0]))
        for le, value in buckets:
            samples.append(('_bucket', {**labels, 'le': le}, value))
        count = latest.get((pair, 'count', 'None'))
        if count is not None:
            samples.append(('_count', labels, count[1]))
            mean = latest.get((pair, 'mean', 'None'))
            if mean is not None:
                samples.append(('_sum', labels, mean[1] * count[1]))


def _collect_preemptions(session, samples):
    """``mlcomp_preemptions_total{class,reason}`` from the v15
    preemption audit table — durable counter semantics (one row per
    eviction decision, exactly-once per victim attempt), like the
    sweep-prune family. ``class`` is the VICTIM's scheduling class."""
    if not session.table_columns('preemption'):
        return
    for r in session.query(
            'SELECT victim_class, reason, COUNT(*) AS n '
            'FROM preemption GROUP BY victim_class, reason '
            'ORDER BY victim_class, reason'):
        samples.append((
            '_total',
            {'class': r['victim_class'] or 'unknown',
             'reason': r['reason'] or 'unknown'}, r['n']))


def _collect_quota(session, samples):
    """``mlcomp_quota_usage{scope,tenant,resource,kind}``: every quota
    ceiling (kind=limit) beside the usage admission measures against it
    (kind=used): live held cores, or core-seconds settled in the
    tenant's ledger window. A tenant without a row is unlimited, and
    absent."""
    if not session.table_columns('quota'):
        return
    from mlcomp_tpu_torch.db.providers.quota import QuotaProvider
    for q, used in QuotaProvider(session).all_with_usage():
        labels = {'scope': q.scope, 'tenant': q.tenant,
                  'resource': q.resource}
        samples.append(('', {**labels, 'kind': 'limit'},
                        float(q.limit_value or 0.0)))
        samples.append(('', {**labels, 'kind': 'used'}, float(used)))

def _collect_queue_max_wait(session, samples):
    """``mlcomp_queue_max_wait_seconds{class}`` — the supervisor's
    per-tick starvation gauge over the LIVE pending queue: age of the
    oldest unclaimed dispatch per scheduling class, 0 when the class
    queue is empty. The acceptance metric for bounded-wait fairness
    (docs/scheduling.md)."""
    pattern = re.compile(r'^queue\.max_wait_s\.(.+)$')
    latest = {}
    for r in session.query(
            "SELECT id, name, value FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name LIKE 'queue.max_wait_s.%'",
            (_SERVING_SCAN_WINDOW,)):
        m = pattern.match(r['name'])
        if m is None:
            continue
        cls = m.group(1)
        if cls not in latest or r['id'] > latest[cls][0]:
            latest[cls] = (r['id'], r['value'])
    for cls, (_, value) in sorted(latest.items()):
        samples.append(('', {'class': cls}, value))


def _collect_slo(session, bad_samples, burn_samples):
    """SLO engine gauges (telemetry/slo.py): the latest instantaneous
    bad-fraction SLI per objective plus the latest fast/slow burn
    rates — the numbers the engine's alert verdicts are computed from,
    re-exported so a Grafana burn-rate panel shows exactly what the
    alerting path saw."""
    stats = {'bad': None, 'burn_fast': 'fast', 'burn_slow': 'slow'}
    latest = {}      # (key, stat) -> (id, value)
    for r in session.query(
            "SELECT id, name, value FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name LIKE 'slo.%'", (_SERVING_SCAN_WINDOW,)):
        rest = r['name'][len('slo.'):]
        if '.' not in rest:
            continue
        key, stat = rest.rsplit('.', 1)
        if stat not in stats:
            continue
        mkey = (key, stat)
        if mkey not in latest or r['id'] > latest[mkey][0]:
            latest[mkey] = (r['id'], r['value'])
    for (key, stat), (_, value) in sorted(latest.items()):
        if stat == 'bad':
            bad_samples.append(('', {'objective': key}, value))
        else:
            burn_samples.append(
                ('', {'objective': key, 'window': stats[stat]},
                 value))


def _collect_supervisor_ha(session, leader, epoch, failovers, fenced):
    """Supervisor HA families (migration v12 + server/ha.py):

    - ``mlcomp_supervisor_leader{computer,holder}`` — 1 while a live
      (unexpired) lease names a leader; the vacant/expired state is a
      MISSING sample, which is what an alert should page on;
    - ``mlcomp_supervisor_epoch`` — the current fencing token; a bump
      without a deploy is a failover;
    - ``mlcomp_supervisor_failovers_total`` — promotion events from
      the ``supervisor.failover`` metric rows (first-boot acquisitions
      excluded: epoch 1 is a start, not a failover);
    - ``mlcomp_supervisor_fenced_writes_total`` — zombie writes the
      epoch fence rejected (db/fencing.py); nonzero means a paused
      ex-leader actually came back and was actually stopped."""
    row = session.query_one('SELECT * FROM supervisor_lease WHERE id=1')
    if row is not None:
        epoch.append(('', None, row['epoch'] or 0))
        from mlcomp_tpu_torch.db.core import parse_datetime
        from mlcomp_tpu_torch.utils.misc import now as _now
        expires = parse_datetime(row['expires_at'])
        if row['holder'] and expires is not None and expires > _now():
            leader.append(
                ('', {'computer': row['holder'].split(':', 1)[0],
                      'holder': row['holder']}, 1))
    n_failovers = 0
    for r in session.query(
            "SELECT tags FROM metric "
            "WHERE id > (SELECT COALESCE(MAX(id), 0) FROM metric) - ? "
            "AND name='supervisor.failover'", (_RETRY_SCAN_WINDOW,)):
        try:
            if not json.loads(r['tags'] or '{}').get('first_boot'):
                n_failovers += 1
        except ValueError:
            n_failovers += 1
    failovers.append(('_total', {}, n_failovers))
    r = session.query_one(
        "SELECT SUM(value) AS total FROM metric "
        "WHERE name='supervisor.fenced_writes'")
    fenced.append(
        ('_total', {}, float(r['total'] or 0) if r else 0.0))


def _collect_listener_reconnects(session, samples):
    """``mlcomp_db_listener_reconnects_total`` — LISTEN/NOTIFY daemon
    reconnect events (sum of flushed ``db.listener_reconnects``
    deltas, same protocol as the busy-retry family). A climbing count
    means cross-process wakeups keep flapping back to the poll
    backstop — dispatch latency degrades before anything errors."""
    r = session.query_one(
        "SELECT SUM(value) AS total FROM metric "
        "WHERE name='db.listener_reconnects'")
    samples.append(
        ('_total', {}, float(r['total'] or 0) if r else 0.0))


def collect_server_families(session):
    """The API server's /metrics families, each collected defensively
    from the DB. Scrape self-observability: ``mlcomp_scrape_errors``
    carries one labeled sample PER collector (a single aggregate
    counter says "something is sick" without saying what — the label
    names the sick collector), and ``mlcomp_scrape_duration_seconds``
    times the whole collect so a scrape slowly drowning in table
    growth is visible before Prometheus starts timing out."""
    t_scrape = time.perf_counter()
    errors = {}

    def guarded(name, fn, *args):
        errors.setdefault(name, 0)
        try:
            fn(*args)
        except Exception:
            errors[name] += 1

    tasks, queues, slots, alerts = [], [], [], []
    dispatch, phases, eff, compiles, serving = [], [], [], [], []
    retries, gangs, busy = [], [], []
    freplicas, fgens, fshed, frespawns, fswaps = [], [], [], [], []
    sweep_cells, sweep_prunes, sweep_rungs = [], [], []
    hbm, comm_bytes, comm_frac = [], [], []
    devtime_ms, devtime_frac = [], []
    leader, epoch, failovers, fenced, reconnects = [], [], [], [], []
    usage_cores, usage_tasks = [], []
    qwait, qmax, slo_bad, slo_burn = [], [], [], []
    preemptions, quota = [], []
    guarded('tasks', _collect_tasks, session, tasks)
    guarded('queue_depth', _collect_queue_depth, session, queues)
    guarded('worker_slots', _collect_worker_slots, session, slots)
    guarded('alerts', _collect_alerts, session, alerts)
    guarded('dispatch_latency', _collect_dispatch_latency, session,
            dispatch)
    guarded('task_retries', _collect_task_retries, session, retries)
    guarded('db_busy', _collect_db_busy, session, busy)
    guarded('gang_generations', _collect_gang_generations, session,
            gangs)
    guarded('fleet_replicas', _collect_fleet_replicas, session,
            freplicas)
    guarded('fleet_generations', _collect_fleet_generations, session,
            fgens)
    guarded('fleet_shed', _collect_fleet_shed, session, fshed)
    guarded('fleet_events', _collect_fleet_events, session, frespawns,
            fswaps)
    guarded('sweeps', _collect_sweeps, session, sweep_cells,
            sweep_prunes, sweep_rungs)
    guarded('supervisor_ha', _collect_supervisor_ha, session, leader,
            epoch, failovers, fenced)
    guarded('listener_reconnects', _collect_listener_reconnects,
            session, reconnects)
    guarded('usage', _collect_usage, session, usage_cores,
            usage_tasks)
    guarded('queue_wait', _collect_queue_wait, session, qwait)
    guarded('queue_max_wait', _collect_queue_max_wait, session, qmax)
    guarded('preemptions', _collect_preemptions, session, preemptions)
    guarded('quota', _collect_quota, session, quota)
    guarded('slo', _collect_slo, session, slo_bad, slo_burn)
    running = []
    errors.setdefault('running_tasks', 0)
    try:
        running = _running_task_ids(session)
    except Exception:
        errors['running_tasks'] += 1
    guarded('step_phases', _collect_step_phases, session, running,
            phases, eff)
    guarded('compile_events', _collect_compile_events, session,
            running, compiles)
    guarded('hbm', _collect_hbm, session, running, hbm)
    guarded('comm', _collect_comm, session, running, comm_bytes,
            comm_frac)
    guarded('devtime', _collect_devtime, session, running, devtime_ms,
            devtime_frac)
    guarded('serving_latency', _collect_serving_latency, session,
            serving)
    error_samples = [('', {'collector': name}, n)
                     for name, n in sorted(errors.items())]
    duration = time.perf_counter() - t_scrape
    return [
        family('mlcomp_up', 'gauge',
               'API server is serving this scrape', [('', None, 1)]),
        family('mlcomp_tasks', 'gauge',
               'tasks by status', tasks),
        family('mlcomp_queue_depth', 'gauge',
               'pending queue messages per queue', queues),
        family('mlcomp_worker_slots', 'gauge',
               'card slots per computer (state=total|busy)',
               slots),
        family('mlcomp_alerts_open', 'gauge',
               'open watchdog alerts by rule and severity', alerts),
        family('mlcomp_dispatch_latency_seconds', 'summary',
               'supervisor enqueue-to-claim latency (latest flush '
               'window)', dispatch),
        family('mlcomp_step_phase_ms', 'gauge',
               'latest per-step phase attribution (newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', phases),
        family('mlcomp_pipeline_efficiency', 'gauge',
               'compute share of attributed step time (newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', eff),
        family('mlcomp_compile_events', 'counter',
               'recorded compile events (newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', compiles),
        family('mlcomp_task_retries', 'counter',
               'automatic task retries by failure reason '
               '(recovery subsystem; recent event window)', retries),
        family('mlcomp_db_busy_retries', 'counter',
               'sqlite SQLITE_BUSY retry/give-up events on the '
               'control plane (sum of flushed db.busy_* deltas)',
               busy),
        family('mlcomp_gang_generations', 'counter',
               'gang-atomic requeue events by gang and failure reason '
               '(elastic multi-host recovery; recent event window)',
               gangs),
        family('mlcomp_serving_latency_ms', 'histogram',
               'served-model request latency (cumulative buckets, '
               'latest heartbeat snapshot)', serving),
        family('mlcomp_fleet_replicas', 'gauge',
               'serving-fleet replicas by state (reconciler view)',
               freplicas),
        family('mlcomp_fleet_generation', 'gauge',
               'active (routed) swap generation per fleet', fgens),
        family('mlcomp_fleet_shed', 'counter',
               'requests shed by SLO-keyed admission control (latest '
               'gateway flush, cumulative at source)', fshed),
        family('mlcomp_fleet_respawns', 'counter',
               'replica respawn events by failure reason (recent '
               'event window)', frespawns),
        family('mlcomp_fleet_swaps', 'counter',
               'rolling-swap events by outcome (recent event window)',
               fswaps),
        family('mlcomp_sweep_cells', 'gauge',
               'ASHA sweep cells by state (pruned = killed by a rung '
               'verdict; server/sweep.py)', sweep_cells),
        family('mlcomp_sweep_prunes', 'counter',
               'prune verdicts per sweep and rung (sweep_decision '
               'audit table — durable counter)', sweep_prunes),
        family('mlcomp_sweep_rung', 'gauge',
               'highest rung judged per sweep (-1 before the first '
               'verdict)', sweep_rungs),
        family('mlcomp_hbm_bytes', 'gauge',
               'latest HBM timeline point per running task and device '
               '(kind=used|limit|peak; telemetry memory sampler, '
               f'newest {_RUNNING_TASKS_CAP} running tasks)', hbm),
        family('mlcomp_comm_bytes', 'gauge',
               'per-device collective bytes per compiled step by op '
               '(HLO walk; newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', comm_bytes),
        family('mlcomp_comm_fraction', 'gauge',
               'measured collective share of the step (wire probe / '
               f'step time; newest {_RUNNING_TASKS_CAP} running '
               'tasks)', comm_frac),
        family('mlcomp_devtime_ms', 'gauge',
               'newest sampled device-time window by bucket '
               '(compute|comm|comm_exposed|io|idle, summed across '
               'device lines; telemetry deviceprof, newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', devtime_ms),
        family('mlcomp_devtime_exposed_comm_fraction', 'gauge',
               'collective time NOT overlapped with compute in the '
               'newest sampled window (trace-measured; newest '
               f'{_RUNNING_TASKS_CAP} running tasks)', devtime_frac),
        family('mlcomp_supervisor_leader', 'gauge',
               '1 while a live supervisor lease names a leader '
               '(labels: computer, holder) — a missing sample means '
               'the lease is vacant or expired', leader),
        family('mlcomp_supervisor_epoch', 'gauge',
               'current supervisor fencing epoch (bumps on every '
               'acquisition; a bump without a deploy is a failover)',
               epoch),
        family('mlcomp_supervisor_failovers', 'counter',
               'supervisor leader promotions excluding first boot '
               '(recent event window)', failovers),
        family('mlcomp_supervisor_fenced_writes', 'counter',
               'zombie ex-leader writes rejected by the epoch fence '
               '(sum of flushed supervisor.fenced_writes deltas)',
               fenced),
        family('mlcomp_db_listener_reconnects', 'counter',
               'LISTEN/NOTIFY listener reconnect events (sum of '
               'flushed db.listener_reconnects deltas)', reconnects),
        family('mlcomp_usage_core_seconds', 'counter',
               'billed card-seconds per tenant from the usage '
               'ledger (append-only, exactly-once per terminal '
               'attempt — migration v14)', usage_cores),
        family('mlcomp_usage_tasks', 'counter',
               'folded terminal task attempts per tenant (usage '
               'ledger rows)', usage_tasks),
        family('mlcomp_queue_wait_seconds', 'histogram',
               'enqueue-to-claim wait per scheduling class '
               '(cumulative buckets, latest supervisor flush)', qwait),
        family('mlcomp_queue_max_wait_seconds', 'gauge',
               'age of the oldest still-pending dispatch per '
               'scheduling class (starvation gauge, 0 = empty queue)',
               qmax),
        family('mlcomp_preemptions', 'counter',
               'checkpoint-preemption evictions by victim class and '
               'reason (preemption audit table — durable counter, '
               'exactly-once per victim attempt; migration v15)',
               preemptions),
        family('mlcomp_quota_usage', 'gauge',
               'fair-share quota ceilings (kind=limit) and the usage '
               'admission measures against them (kind=used) per '
               'scope/tenant/resource — absent tenant = unlimited',
               quota),
        family('mlcomp_slo_bad_fraction', 'gauge',
               'latest instantaneous SLI bad-fraction per SLO '
               'objective (telemetry/slo.py)', slo_bad),
        family('mlcomp_slo_burn_rate', 'gauge',
               'error-budget burn rate per SLO objective and window '
               '(fast=5m, slow=6h; >= 14.4 fast pages, >= 6 slow '
               'warns)', slo_burn),
        family('mlcomp_scrape_errors', 'gauge',
               'failures during this scrape, labeled by collector '
               '(the endpoint never 500s on a sick DB — the label '
               'says WHICH read is sick)', error_samples),
        family('mlcomp_scrape_duration_seconds', 'gauge',
               'wall-clock of this scrape\'s DB collection',
               [('', None, round(duration, 6))]),
    ]


def render_server_metrics(session) -> str:
    return render_openmetrics(collect_server_families(session))


__all__ = ['render_openmetrics', 'parse_openmetrics', 'family',
           'collect_server_families', 'render_server_metrics',
           'OPENMETRICS_CONTENT_TYPE', 'REQUIRED_FAMILIES',
           'WAITING_FAMILIES']

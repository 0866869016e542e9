"""Telemetry providers (port of ``mlcomp_tpu/db/providers/telemetry.py``:
metric, span and alert rows) — batch ingest, and the reads the API
serves (series and their tails, span forests, assembled traces,
alerts).

The write path is ``add_many`` (one executemany per flush) because the
telemetry buffers hand over hundreds of rows at a time; per-row ``add``
would pay a commit each. ``AlertProvider.raise_alert`` is what the
supervisor's retry pass writes; ``PostmortemProvider`` holds the
bundles ``TaskProvider.fail_with_reason`` freezes
(``telemetry/memory.py``).
"""

import json

from mlcomp_tpu_torch.db.models import (
    Alert, Metric, Postmortem, TelemetrySpan,
)
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class MetricProvider(BaseDataProvider):
    model = Metric

    _INSERT = ('INSERT INTO metric '
               '(task, name, kind, step, value, time, component, tags) '
               'VALUES (?, ?, ?, ?, ?, ?, ?, ?)')

    def add_many(self, rows):
        """``rows``: iterables matching _INSERT's column order."""
        rows = list(rows)
        if rows:
            self.session.executemany(self._INSERT, rows)
        return len(rows)

    def series(self, task_id=None, name=None, component=None,
               limit: int = 100000, offset: int = 0):
        """Samples grouped by metric name, each ordered by (step, id):
        ``{name: [{'step':, 'value':, 'time':, 'kind':}, ...]}``."""
        where, params = [], []
        if task_id is not None:
            where.append('task=?')
            params.append(int(task_id))
        if name is not None:
            where.append('name=?')
            params.append(name)
        if component is not None:
            where.append('component=?')
            params.append(component)
        sql = 'SELECT * FROM metric'
        if where:
            sql += ' WHERE ' + ' AND '.join(where)
        sql += ' ORDER BY name, COALESCE(step, id), id LIMIT ? OFFSET ?'
        params.append(int(limit))
        params.append(int(offset))
        out = {}
        for r in self.session.query(sql, tuple(params)):
            out.setdefault(r['name'], []).append({
                'step': r['step'], 'value': r['value'],
                'time': r['time'], 'kind': r['kind'],
                'tags': self._decode_tags(r['tags'])})
        return out

    @staticmethod
    def _decode_tags(raw):
        """Decoded sample tags (or None) — the convention every JSON
        surface uses (span tags, alert details): consumers must not
        double-decode. The retry-history card reads the per-event
        ``reason`` from here."""
        if not raw:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def tail_series(self, task_id: int, per_name: int = 64):
        """Latest ``per_name`` samples of EVERY metric name of a task,
        each series ascending within its window — the bounded
        "what is happening NOW" read. The plain ``series()`` ascending
        LIMIT walks names alphabetically, so on a long run it
        truncates the NEWEST samples of later-sorting names; this one
        takes each name's indexed id-DESC tail instead."""
        out = {}
        for name in self.names(task_id):
            rows = self.session.query(
                'SELECT step, value, time, kind, tags FROM metric '
                'WHERE task=? AND name=? ORDER BY id DESC LIMIT ?',
                (int(task_id), name, int(per_name)))
            out[name] = [{'step': r['step'], 'value': r['value'],
                          'time': r['time'], 'kind': r['kind'],
                          'tags': self._decode_tags(r['tags'])}
                         for r in reversed(rows)]
        return out

    def names(self, task_id=None, like: str = None):
        """Distinct metric names, optionally restricted to a task
        and/or a LIKE pattern. With the (task, name) composite index
        (migration v6) the task-scoped form is an index skip, not a
        table scan — the watchdog calls this per running task."""
        where, params = [], []
        if task_id is not None:
            where.append('task=?')
            params.append(int(task_id))
        if like is not None:
            where.append('name LIKE ?')
            params.append(like)
        sql = 'SELECT DISTINCT name FROM metric'
        if where:
            sql += ' WHERE ' + ' AND '.join(where)
        return [r['name'] for r in self.session.query(
            sql + ' ORDER BY name', tuple(params))]


class TelemetrySpanProvider(BaseDataProvider):
    model = TelemetrySpan

    _INSERT = ('INSERT INTO telemetry_span '
               '(span_id, parent_id, task, name, started, duration, '
               'status, tags, trace_id, process_role) '
               'VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)')

    def add_many(self, rows):
        rows = list(rows)
        if rows:
            self.session.executemany(self._INSERT, rows)
        return len(rows)

    def by_task(self, task_id: int, limit: int = 100000,
                offset: int = 0):
        rows = self.session.query(
            'SELECT * FROM telemetry_span WHERE task=? '
            'ORDER BY started, id LIMIT ? OFFSET ?',
            (int(task_id), int(limit), int(offset)))
        return [TelemetrySpan.from_row(r) for r in rows]

    @staticmethod
    def _forest(spans):
        """Parent→children forest of span dicts (tags decoded), start
        order preserved. Span ids are process-scoped, so a parent_id minted
        in another process never resolves — those spans become roots,
        which is exactly the cross-process seam the trace view shows."""
        nodes, by_id = [], {}
        for s in spans:
            node = s.to_dict()
            try:
                node['tags'] = json.loads(node['tags']) \
                    if node['tags'] else None
            except ValueError:
                pass
            node['children'] = []
            by_id[node['span_id']] = node
            nodes.append(node)
        roots = []
        for node in nodes:
            parent = by_id.get(node['parent_id'])
            if parent is not None and parent is not node:
                parent['children'].append(node)
            else:
                roots.append(node)
        return roots

    def tree(self, task_id: int, limit: int = 100000,
             offset: int = 0):
        """Spans of a task as a parent→children forest of dicts (tags
        decoded), ordered by start time — the shape the dashboard and
        ``GET /telemetry/spans`` serve."""
        return self._forest(self.by_task(task_id, limit=limit,
                                         offset=offset))

    def by_trace(self, trace_id: str, limit: int = 100000):
        rows = self.session.query(
            'SELECT * FROM telemetry_span WHERE trace_id=? '
            'ORDER BY started, id LIMIT ?', (trace_id, int(limit)))
        return [TelemetrySpan.from_row(r) for r in rows]

    def trace_tree(self, trace_id: str):
        """The assembled cross-process trace: every span carrying this
        trace_id, grouped into per-process root forests (one root per
        (pid-prefix, process_role) seam), plus the wall-clock envelope
        the dashboard waterfall scales against."""
        spans = self.by_trace(trace_id)
        roots = self._forest(spans)
        processes = []
        seen = set()
        for s in spans:
            # the full '{pid}.{rand}' prefix, not the bare pid: two
            # hosts/containers can both run pid 42 in one trace
            prefix = (s.span_id or '').rsplit('-', 1)[0]
            key = (prefix, s.process_role)
            if key not in seen:
                seen.add(key)
                processes.append(
                    {'pid': prefix, 'role': s.process_role})
        started = [s.started for s in spans if s.started is not None]
        t0 = min(started) if started else None
        t1 = max((s.started + (s.duration or 0) for s in spans
                  if s.started is not None), default=None)
        return {'trace_id': trace_id, 'span_count': len(spans),
                'processes': processes, 'started': t0, 'finished': t1,
                'spans': roots}


class PostmortemProvider(BaseDataProvider):
    """Frozen failure bundles (telemetry/memory.py flight recorder) —
    append-only; one row per reasoned failure event, newest wins."""

    model = Postmortem

    def latest(self, task_id: int):
        row = self.session.query_one(
            'SELECT * FROM postmortem WHERE task=? '
            'ORDER BY id DESC LIMIT 1', (int(task_id),))
        return Postmortem.from_row(row) if row else None

    def of_task(self, task_id: int, limit: int = 20):
        rows = self.session.query(
            'SELECT * FROM postmortem WHERE task=? '
            'ORDER BY id DESC LIMIT ?', (int(task_id), int(limit)))
        return [Postmortem.from_row(r) for r in rows]

    def prune(self, task_id: int, keep: int = 5) -> int:
        """Drop all but the newest ``keep`` bundles of a task — a
        flapping task retried many times must not grow the table one
        multi-KB bundle per failure event forever (the metric rows a
        bundle snapshots age out; the bundles themselves need the
        same bound)."""
        cur = self.session.execute(
            'DELETE FROM postmortem WHERE task=? AND id NOT IN ('
            'SELECT id FROM postmortem WHERE task=? '
            'ORDER BY id DESC LIMIT ?)',
            (int(task_id), int(task_id), max(1, int(keep))))
        return cur.rowcount


class AlertProvider(BaseDataProvider):
    model = Alert

    def raise_alert(self, rule: str, message: str, task=None, dag=None,
                    computer=None, severity: str = 'warning',
                    details: dict = None):
        """Insert an alert, deduplicated against an OPEN alert of the
        same (rule, task): one live condition stays one row,
        re-touched."""
        existing = self.session.query_one(
            'SELECT id FROM alert WHERE rule=? AND status=\'open\' '
            'AND task IS ?', (rule, task if task is None else int(task)))
        payload = json.dumps(details) if details else None
        if existing is not None:
            self.session.execute(
                'UPDATE alert SET time=?, message=?, severity=?, '
                'details=? WHERE id=?',
                (now(), message, severity, payload, existing['id']))
            return self.by_id(existing['id'])
        alert = Alert(time=now(), rule=rule, severity=severity,
                      task=task, dag=dag, computer=computer,
                      message=message, details=payload, status='open')
        self.add(alert)
        return alert

    def get(self, status: str = 'open', task=None, rule=None,
            limit: int = 200, offset: int = 0):
        where, params = [], []
        if status:
            where.append('status=?')
            params.append(status)
        if task is not None:
            where.append('task=?')
            params.append(int(task))
        if rule is not None:
            where.append('rule=?')
            params.append(rule)
        sql = 'SELECT * FROM alert'
        if where:
            sql += ' WHERE ' + ' AND '.join(where)
        sql += ' ORDER BY time DESC, id DESC LIMIT ? OFFSET ?'
        params.append(int(limit))
        params.append(int(offset))
        return [Alert.from_row(r)
                for r in self.session.query(sql, tuple(params))]

    @staticmethod
    def serialize(alert):
        """Alert as a jsonable dict with ``details`` DECODED — the
        shape /api/alerts and the CLI serve (same convention as span
        ``tags`` in _forest; a raw JSON string inside JSON would make
        every consumer double-decode)."""
        out = alert.to_dict()
        if out.get('details'):
            try:
                out['details'] = json.loads(out['details'])
            except ValueError:
                pass
        return out

    def resolve(self, alert_id: int) -> bool:
        cur = self.session.execute(
            "UPDATE alert SET status='resolved', resolved_time=? "
            "WHERE id=? AND status='open'", (now(), int(alert_id)))
        return cur.rowcount > 0


__all__ = ['MetricProvider', 'TelemetrySpanProvider', 'AlertProvider',
           'PostmortemProvider']

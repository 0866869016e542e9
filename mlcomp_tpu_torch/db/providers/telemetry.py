"""Telemetry providers (port of ``mlcomp_tpu/db/providers/telemetry.py``:
metric and span rows) — batch ingest, and the reads the tests and a
notebook use.

The write path is ``add_many`` (one executemany per flush) because the
telemetry buffers hand over hundreds of rows at a time; per-row ``add``
would pay a commit each. ``AlertProvider.raise_alert`` is what the
supervisor's retry pass writes; the watchdog's alert reads and the
postmortems come with A6.
"""

import json

from mlcomp_tpu_torch.db.models import Alert, Metric, TelemetrySpan
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


__all__ = ['MetricProvider', 'TelemetrySpanProvider', 'AlertProvider']

"""Dag providers (port of ``mlcomp_tpu/db/providers/dag.py``): the dag
row with the API's listing and graph, and the preflight findings stored
with it."""

from mlcomp_tpu_torch.db.core import adapt_value
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.models import Dag, DagPreflight, Task
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)
from mlcomp_tpu_torch.utils.misc import duration_format, now


class DagProvider(BaseDataProvider):
    model = Dag

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        """DAG list with per-status task counts (reference dag.py:11-100)."""
        filter = filter or {}
        where, params = [], []
        if filter.get('project'):
            where.append('project=?')
            params.append(filter['project'])
        if filter.get('name'):
            where.append('name LIKE ?')
            params.append(f"%{filter['name']}%")
        if filter.get('id'):
            where.append('id=?')
            params.append(filter['id'])
        where_sql = ' AND '.join(where)
        dags = self.query(where_sql, tuple(params), options)
        total = self.count(where_sql, tuple(params))
        data = []
        for dag in dags:
            item = dag.to_dict()
            rows = self.session.query(
                'SELECT status, COUNT(*) AS c, MIN(started) AS s, '
                'MAX(finished) AS f FROM task WHERE dag=? GROUP BY status',
                (dag.id,))
            counts = {int(s): 0 for s in TaskStatus}
            started, finished = [], []
            for r in rows:
                counts[r['status']] = r['c']
                if r['s']:
                    started.append(r['s'])
                if r['f']:
                    finished.append(r['f'])
            item['task_statuses'] = [
                {'name': s.name, 'count': counts[int(s)]}
                for s in TaskStatus
            ]
            item['task_count'] = sum(counts.values())
            item['started'] = min(started) if started else None
            item['finished'] = (
                max(finished)
                if finished and self._all_finished(counts) else None)
            data.append(item)
        return {'total': total, 'data': data}

    @staticmethod
    def _all_finished(counts):
        return all(
            counts[int(s)] == 0 for s in TaskStatus.unfinished())

    def graph(self, dag_id: int):
        """Nodes+edges payload for DAG visualization
        (reference db/providers/dag.py:166-209)."""
        tasks = [Task.from_row(r) for r in self.session.query(
            'SELECT * FROM task WHERE dag=?', (dag_id,))]
        by_id = {t.id: t for t in tasks}
        edges_rows = self.session.query(
            'SELECT td.task_id AS t, td.depend_id AS d '
            'FROM task_dependence td JOIN task x ON td.task_id = x.id '
            'WHERE x.dag=?', (dag_id,))
        nodes = []
        for t in tasks:
            dur = None
            if t.started and t.finished:
                dur = (t.finished - t.started).total_seconds()
            label = t.executor or t.name
            if dur is not None:
                label += f'\n{duration_format(dur)}'
            if t.current_step:
                label += f'\nstep: {t.current_step}'
            nodes.append({
                'id': t.id,
                'label': label,
                'name': t.name,
                'status': TaskStatus(t.status).name,
            })
        edges = []
        for r in edges_rows:
            dep = by_id.get(r['d'])
            edges.append({
                'from': r['d'],
                'to': r['t'],
                'status': TaskStatus(dep.status).name if dep else 'NotRan',
            })
        return {'nodes': nodes, 'edges': edges}

    def config(self, dag_id: int) -> str:
        dag = self.by_id(dag_id)
        return dag.config if dag else ''

    def remove(self, dag_id: int):
        # cascading deletes via FK ON DELETE CASCADE
        for table in ('task_dependence', ):
            self.session.execute(
                f'DELETE FROM {table} WHERE task_id IN '
                f'(SELECT id FROM task WHERE dag=?)', (dag_id,))
        self.session.execute('DELETE FROM task WHERE dag=?', (dag_id,))
        self.session.execute('DELETE FROM dag_storage WHERE dag=?', (dag_id,))
        self.session.execute('DELETE FROM dag_library WHERE dag=?', (dag_id,))
        self.session.execute('DELETE FROM file WHERE dag=?', (dag_id,))
        self.session.execute(
            'DELETE FROM dag_preflight WHERE dag=?', (dag_id,))
        self.session.execute('DELETE FROM dag WHERE id=?', (dag_id,))


class DagPreflightProvider(BaseDataProvider):
    """Preflight findings stored against a dag (analysis/ subsystem)."""

    model = DagPreflight

    _INSERT = ('INSERT INTO dag_preflight '
               '(dag, time, rule, severity, path, line, message, source) '
               'VALUES (?, ?, ?, ?, ?, ?, ?, ?)')

    def add_findings(self, dag_id: int, findings, source: str = 'submit'):
        """Batch-store analysis Findings (analysis/findings.py)."""
        ts = adapt_value(now())
        rows = [(int(dag_id), ts, f.rule, f.severity, f.path, f.line,
                 f.message, source) for f in findings]
        if rows:
            self.session.executemany(self._INSERT, rows)
        return len(rows)

    def clear(self, dag_id: int, source: str = None):
        if source is None:
            self.session.execute(
                'DELETE FROM dag_preflight WHERE dag=?', (int(dag_id),))
        else:
            self.session.execute(
                'DELETE FROM dag_preflight WHERE dag=? AND source=?',
                (int(dag_id), source))

    def by_dag(self, dag_id: int) -> list:
        rows = self.session.query(
            'SELECT * FROM dag_preflight WHERE dag=? '
            'ORDER BY CASE severity WHEN \'error\' THEN 0 ELSE 1 END, id',
            (int(dag_id),))
        return [self.model.from_row(r) for r in rows]


__all__ = ['DagProvider', 'DagPreflightProvider']

"""Dag providers (port of ``mlcomp_tpu/db/providers/dag.py``): the dag
row and the preflight findings stored with it; the UI's dag queries
wait (ROADMAP.md, A0)."""

from mlcomp_tpu_torch.db.core import adapt_value
from mlcomp_tpu_torch.db.models import Dag, DagPreflight
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class DagProvider(BaseDataProvider):
    model = Dag


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

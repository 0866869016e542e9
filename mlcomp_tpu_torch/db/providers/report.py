"""Report providers (port of ``mlcomp_tpu/db/providers/report.py``: what
the DAG builder and the trainer write).

- ReportProvider, ReportTasksProvider: a report and its tasks
- ReportSeriesProvider: metric series rows
- ReportLayoutProvider: the named layouts with ``extend:`` union

Report images and the UI's report queries wait (ROADMAP.md, A0).
"""

from mlcomp_tpu_torch.db.models import (
    Report, ReportLayout, ReportSeries, ReportTasks
)
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.io import yaml_load


class ReportSeriesProvider(BaseDataProvider):
    model = ReportSeries

    def by_task(self, task_id: int):
        rows = self.session.query(
            'SELECT * FROM report_series WHERE task=? ORDER BY epoch',
            (task_id,))
        return [ReportSeries.from_row(r) for r in rows]


class ReportTasksProvider(BaseDataProvider):
    model = ReportTasks


class ReportLayoutProvider(BaseDataProvider):
    model = ReportLayout

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM report_layout WHERE name=?', (name,))
        return ReportLayout.from_row(row) if row else None

    def resolved(self, name: str) -> dict:
        """Layout content with ``extend:`` chains merged — items/metric are
        union'd parent-first (reference db/report_info/info.py:105-129)."""
        seen = set()
        chain = []
        cur = name
        while cur and cur not in seen:
            seen.add(cur)
            layout = self.by_name(cur)
            if layout is None:
                break
            data = yaml_load(layout.content)
            chain.append(data)
            cur = data.get('extend')
        merged = {'items': {}, 'layout': [], 'metric': None}
        for data in reversed(chain):
            merged['items'].update(data.get('items') or {})
            merged['layout'] = (merged['layout'] or []) + \
                (data.get('layout') or [])
            if data.get('metric'):
                merged['metric'] = data['metric']
        return merged


class ReportProvider(BaseDataProvider):
    model = Report


__all__ = ['ReportProvider', 'ReportSeriesProvider', 'ReportTasksProvider',
           'ReportLayoutProvider']

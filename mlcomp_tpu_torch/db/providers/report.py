"""Report providers (port of ``mlcomp_tpu/db/providers/report.py``).

- ReportProvider, ReportTasksProvider: a report, its tasks and the
  assembled detail the API serves
- ReportSeriesProvider: metric series rows
- ReportImgProvider: the image galleries with the confusion matrix
- ReportLayoutProvider: the named layouts with ``extend:`` union
"""

import base64

from mlcomp_tpu_torch.db.models import (
    Report, ReportImg, ReportLayout, ReportSeries, ReportTasks
)
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.misc import now


class ReportSeriesProvider(BaseDataProvider):
    model = ReportSeries

    def by_task(self, task_id: int):
        rows = self.session.query(
            'SELECT * FROM report_series WHERE task=? ORDER BY epoch',
            (task_id,))
        return [ReportSeries.from_row(r) for r in rows]


class ReportTasksProvider(BaseDataProvider):
    model = ReportTasks

    def add_task(self, report: int, task: int):
        self.add(ReportTasks(report=report, task=task))

    def tasks_of(self, report: int):
        rows = self.session.query(
            'SELECT task FROM report_tasks WHERE report=?', (report,))
        return [r['task'] for r in rows]

    def remove_task(self, report: int, task: int):
        self.session.execute(
            'DELETE FROM report_tasks WHERE report=? AND task=?',
            (report, task))


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

    def all_layouts(self):
        return {
            layout.name: yaml_load(layout.content)
            for layout in self.all()
        }

    @staticmethod
    def check_layout(content: str) -> dict:
        """Validate layout yaml structure (reference
        db/report_info/info.py:28-75 ``_check_layout``): a mapping with
        optional ``items`` (name -> {type, ...}), ``layout`` (list of
        panels with ``type``), ``metric`` and ``extend``."""
        data = yaml_load(content)
        if not isinstance(data, dict):
            raise ValueError('layout must be a yaml mapping')
        unknown = set(data) - {'items', 'layout', 'metric', 'extend'}
        if unknown:
            raise ValueError(f'unknown layout keys: {sorted(unknown)}')
        items = data.get('items') or {}
        if not isinstance(items, dict):
            raise ValueError('items must be a mapping')
        for name, spec in items.items():
            if not isinstance(spec, dict) or 'type' not in spec:
                raise ValueError(f'item {name!r} needs a type')
        panels = data.get('layout') or []
        if not isinstance(panels, list):
            raise ValueError('layout must be a list of panels')
        for panel in panels:
            if not isinstance(panel, dict) or 'type' not in panel:
                raise ValueError('every layout entry needs a type')
            for item in panel.get('items') or []:
                # an item may carry its own type OR reference a typed
                # entry in items{} via source (the renderer supports both)
                if not isinstance(item, dict) or \
                        ('type' not in item and 'source' not in item):
                    raise ValueError(
                        'every panel item needs a type or source')
        return data

    def add_layout(self, name: str, content: str):
        self.check_layout(content)
        self.add(ReportLayout(
            name=name, content=content, last_modified=now()))

    def update_layout(self, name: str, content: str, new_name: str = None):
        layout = self.by_name(name)
        if layout is None:
            return False
        self.check_layout(content)
        layout.content = content
        layout.last_modified = now()
        if new_name:
            layout.name = new_name
        self.update(layout)
        return True


class ReportProvider(BaseDataProvider):
    model = Report

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        if filter.get('task'):
            where.append(
                'id IN (SELECT report FROM report_tasks WHERE task=?)')
            params.append(filter['task'])
        where_sql = ' AND '.join(where)
        reports = self.query(where_sql, tuple(params), options)
        total = self.count(where_sql, tuple(params))
        data = []
        for rep in reports:
            item = rep.to_dict()
            tasks = self.session.query(
                'SELECT COUNT(*) AS c FROM report_tasks WHERE report=?',
                (rep.id,))
            item['tasks_count'] = tasks[0]['c'] if tasks else 0
            data.append(item)
        return {'total': total, 'data': data}

    def detail(self, report_id: int):
        """Assembled report: layout + series grouped per item
        (reference report/report.py:40-150)."""
        rep = self.by_id(report_id)
        if rep is None:
            return {}
        layout = yaml_load(rep.config) if rep.config else {}
        task_ids = ReportTasksProvider(self.session).tasks_of(report_id)
        series = []
        if task_ids:
            marks = ','.join('?' * len(task_ids))
            rows = self.session.query(
                f'SELECT rs.*, t.name AS task_name FROM report_series rs '
                f'JOIN task t ON rs.task = t.id '
                f'WHERE rs.task IN ({marks}) ORDER BY rs.epoch',
                tuple(task_ids))
            grouped = {}
            for r in rows:
                key = (r['name'], r['part'])
                grouped.setdefault(key, []).append({
                    'task': r['task'], 'task_name': r['task_name'],
                    'epoch': r['epoch'], 'value': r['value'],
                    'stage': r['stage'],
                })
            for (name, part), points in grouped.items():
                series.append({'name': name, 'part': part, 'data': points})
        return {
            'id': report_id,
            'layout': layout,
            'series': series,
            'tasks': task_ids,
        }

    def update_layout_start(self, report_id: int):
        rep = self.by_id(report_id)
        return {'layouts': list(
            ReportLayoutProvider(self.session).all_layouts()),
            'current': rep.layout if rep else None}

    def update_layout_end(self, report_id: int, layout_name: str):
        rep = self.by_id(report_id)
        if rep is None:
            return False
        layouts = ReportLayoutProvider(self.session)
        resolved = layouts.resolved(layout_name)
        rep.layout = layout_name
        rep.config = yaml_dump(resolved)
        self.update(rep)
        return True


class ReportImgProvider(BaseDataProvider):
    model = ReportImg

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        for key in ('task', 'dag', 'project', 'part', 'epoch'):
            if filter.get(key) is not None:
                where.append(f'"{key}"=?')
                params.append(filter[key])
        if filter.get('tasks'):
            tasks = list(filter['tasks'])
            where.append(f'task IN ({",".join("?" * len(tasks))})')
            params += tasks
        if filter.get('group'):
            where.append('"group"=?')
            params.append(filter['group'])
        if filter.get('y') is not None:
            where.append('y=?')
            params.append(filter['y'])
        if filter.get('y_pred') is not None:
            where.append('y_pred=?')
            params.append(filter['y_pred'])
        if filter.get('score_min') is not None:
            where.append('score>=?')
            params.append(filter['score_min'])
        if filter.get('score_max') is not None:
            where.append('score<=?')
            params.append(filter['score_max'])
        where_sql = (' WHERE ' + ' AND '.join(where)) if where else ''
        options = options or PaginatorOptions()
        offset = options.page_number * options.page_size
        rows = self.session.query(
            f'SELECT * FROM report_img{where_sql} '
            f'ORDER BY id LIMIT ? OFFSET ?',
            tuple(params) + (options.page_size, offset))
        total = self.session.query_one(
            f'SELECT COUNT(*) AS c FROM report_img{where_sql}',
            tuple(params))['c']
        data = []
        for r in rows:
            img = ReportImg.from_row(r)
            item = img.to_dict()
            if item.get('img') is not None:
                item['img'] = base64.b64encode(item['img']).decode()
            data.append(item)
        return {'total': total, 'data': data}

    def confusion_matrix(self, filter: dict):
        """Aggregate (y, y_pred) counts for the gallery's confusion view
        (reference report/img.py confusion handling)."""
        where, params = ['y IS NOT NULL', 'y_pred IS NOT NULL'], []
        for key in ('task', 'dag', 'project', 'part', 'epoch'):
            if filter.get(key) is not None:
                where.append(f'"{key}"=?')
                params.append(filter[key])
        if filter.get('tasks'):
            tasks = list(filter['tasks'])
            where.append(f'task IN ({",".join("?" * len(tasks))})')
            params += tasks
        if filter.get('group'):
            where.append('"group"=?')
            params.append(filter['group'])
        rows = self.session.query(
            f'SELECT y, y_pred, COUNT(*) AS c FROM report_img '
            f'WHERE {" AND ".join(where)} GROUP BY y, y_pred',
            tuple(params))
        if not rows:
            return {'matrix': [], 'n': 0}
        n = max(max(r['y'] for r in rows), max(r['y_pred'] for r in rows)) + 1
        matrix = [[0] * n for _ in range(n)]
        for r in rows:
            matrix[r['y']][r['y_pred']] = r['c']
        return {'matrix': matrix, 'n': n}

    def remove_with_predicate(self, filter: dict):
        where, params = [], []
        for key in ('task', 'dag', 'project'):
            if filter.get(key) is not None:
                where.append(f'"{key}"=?')
                params.append(filter[key])
        if not where:
            return 0
        self.session.execute(
            f'DELETE FROM report_img WHERE {" AND ".join(where)}',
            tuple(params))
        return True


__all__ = ['ReportProvider', 'ReportSeriesProvider', 'ReportImgProvider',
           'ReportTasksProvider', 'ReportLayoutProvider']

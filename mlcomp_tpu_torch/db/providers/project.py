"""Project provider (parity: reference db/providers/project.py:13-104)."""

from mlcomp_tpu_torch.db.models import Project
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)


class ProjectProvider(BaseDataProvider):
    model = Project

    def add_project(self, name: str, class_names: str = None,
                    ignore_folders: str = None, sync_folders: str = None):
        p = Project(name=name, class_names=class_names,
                    ignore_folders=ignore_folders, sync_folders=sync_folders)
        return self.add(p)

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM project WHERE name=?', (name,))
        return Project.from_row(row) if row else None

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        if filter.get('name'):
            where.append('name LIKE ?')
            params.append(f"%{filter['name']}%")
        where_sql = ' AND '.join(where)
        projects = self.query(where_sql, tuple(params), options,
                              default_sort='id')
        data = []
        for p in projects:
            item = p.to_dict()
            counts = self.session.query(
                'SELECT t.status AS status, COUNT(*) AS c FROM task t '
                'JOIN dag d ON t.dag = d.id WHERE d.project=? '
                'GROUP BY t.status', (p.id,))
            item['task_statuses'] = {r['status']: r['c'] for r in counts}
            dag_count = self.session.query_one(
                'SELECT COUNT(*) AS c FROM dag WHERE project=?', (p.id,))
            item['dag_count'] = dag_count['c']
            last = self.session.query_one(
                'SELECT MAX(created) AS m FROM dag WHERE project=?', (p.id,))
            item['last_activity'] = last['m']
            data.append(item)
        total = self.count(where_sql, tuple(params))
        return {'total': total, 'data': data}


__all__ = ['ProjectProvider']

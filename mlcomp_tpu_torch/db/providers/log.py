"""Log provider (parity: reference db/providers/log.py:8-70)."""

from mlcomp_tpu_torch.db.enums import ComponentType, LogStatus
from mlcomp_tpu_torch.db.models import Log
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)


class LogProvider(BaseDataProvider):
    model = Log

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        if filter.get('dag'):
            where.append(
                'l.task IN (SELECT id FROM task WHERE dag=?)')
            params.append(filter['dag'])
        if filter.get('task'):
            where.append('l.task=?')
            params.append(filter['task'])
        if filter.get('components'):
            comps = filter['components']
            where.append(
                f'l.component IN ({",".join("?" * len(comps))})')
            params += comps
        if filter.get('levels'):
            levels = filter['levels']
            where.append(f'l.level IN ({",".join("?" * len(levels))})')
            params += levels
        if filter.get('computer'):
            where.append('l.computer=?')
            params.append(filter['computer'])
        if filter.get('message'):
            where.append('l.message LIKE ?')
            params.append(f"%{filter['message']}%")
        if filter.get('step'):
            where.append('l.step=?')
            params.append(filter['step'])
        where_sql = (' WHERE ' + ' AND '.join(where)) if where else ''
        options = options or PaginatorOptions()
        offset = options.page_number * options.page_size
        rows = self.session.query(
            f'SELECT l.*, t.name AS task_name FROM log l '
            f'LEFT JOIN task t ON l.task = t.id{where_sql} '
            f'ORDER BY l.time DESC LIMIT ? OFFSET ?',
            tuple(params) + (options.page_size, offset))
        total = self.session.query_one(
            f'SELECT COUNT(*) AS c FROM log l{where_sql}',
            tuple(params))['c']
        data = []
        for r in rows:
            item = Log.from_row(r).to_dict()
            item['task_name'] = r['task_name']
            item['component_name'] = ComponentType(item['component']).name
            item['level_name'] = LogStatus(item['level']).name
            data.append(item)
        return {'total': total, 'data': data}


__all__ = ['LogProvider']

"""Computer provider (port of ``mlcomp_tpu/db/providers/computer.py``):
the rows the worker daemon registers and heartbeats, and the listing
and usage history the API serves."""

import json

from mlcomp_tpu_torch.db.models import Computer, ComputerUsage
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class ComputerProvider(BaseDataProvider):
    model = Computer

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM computer WHERE name=?', (name,))
        return Computer.from_row(row) if row else None

    def current_usage(self, name: str, usage: dict):
        c = self.by_name(name)
        if c is not None:
            c.usage = json.dumps(usage)
            self.update(c, ['usage'])

    def update_usage_fields(self, name: str, fields: dict):
        """Merge keys into the live usage JSON without clobbering the
        rest: the process that holds the card (an in-process worker)
        writes the ``tpu`` field, the worker-supervisor the others."""
        c = self.by_name(name)
        if c is None:
            return
        try:
            usage = json.loads(c.usage) if c.usage else {}
        except (ValueError, TypeError):
            usage = {}
        usage.update(fields)
        c.usage = json.dumps(usage)
        self.update(c, ['usage'])

    def add_usage_history(self, name: str, usage: dict, time=None):
        self.add(ComputerUsage(
            computer=name, usage=json.dumps(usage), time=time or now()))

    def get(self, filter: dict = None, options=None):
        data = []
        for r in self.session.query('SELECT * FROM computer'):
            c = Computer.from_row(r)
            item = c.to_dict()
            if item.get('usage'):
                try:
                    item['usage'] = json.loads(item['usage'])
                except (ValueError, TypeError):
                    pass
            dockers = self.session.query(
                'SELECT * FROM docker WHERE computer=?', (c.name,))
            item['dockers'] = [dict(d) for d in dockers]
            data.append(item)
        return {'total': len(data), 'data': data}

    def usage_history(self, computer: str, min_time=None, limit=None):
        sql = 'SELECT * FROM computer_usage WHERE computer=?'
        params = [computer]
        if min_time:
            sql += ' AND time>=?'
            params.append(min_time)
        if limit:
            # newest N only — dashboards poll this; loading the whole
            # history to slice the tail pins the server on big tables
            sql += ' ORDER BY time DESC LIMIT ?'
            params.append(int(limit))
            rows = list(reversed(self.session.query(sql, params)))
        else:
            sql += ' ORDER BY time'
            rows = self.session.query(sql, params)
        mean = []
        for r in rows:
            try:
                u = json.loads(r['usage'])
            except (ValueError, TypeError):
                continue
            u['time'] = r['time']
            mean.append(u)
        return {'mean': mean}


__all__ = ['ComputerProvider']

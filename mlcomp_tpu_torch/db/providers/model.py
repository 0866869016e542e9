"""Model registry provider (port of ``mlcomp_tpu/db/providers/model.py``):
what the trainer's score tracking writes and the API lists. The
dialog payload of ``model/start_begin`` waits with the ``model_start``
DAG (ROADMAP.md, A0)."""

from mlcomp_tpu_torch.db.models import Model
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)


class ModelProvider(BaseDataProvider):
    model = Model

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM model WHERE name=?', (name,))
        return Model.from_row(row) if row else None

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        if filter.get('project'):
            where.append('project=?')
            params.append(filter['project'])
        if filter.get('name'):
            where.append('name LIKE ?')
            params.append(f"%{filter['name']}%")
        if filter.get('dag'):
            where.append('dag=?')
            params.append(filter['dag'])
        where_sql = ' AND '.join(where)
        models = self.query(where_sql, tuple(params), options,
                            default_sort='created')
        total = self.count(where_sql, tuple(params))
        return {'total': total, 'data': [m.to_dict() for m in models]}


__all__ = ['ModelProvider']

"""Model registry provider (port of ``mlcomp_tpu/db/providers/model.py``):
what the trainer's score tracking and ``ModelAdd`` write, the API lists,
and the payload of the "start a pipe for this model" dialog
(``model_start_begin``)."""

from mlcomp_tpu_torch.db.models import Model
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)
from mlcomp_tpu_torch.utils.io import yaml_load


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

    def model_start_begin(self, model_id: int):
        """The pipes of the newest Pipe DAG of the model's project and
        the model's versioned equations; ``{}`` for an unknown model."""
        m = self.by_id(model_id)
        if m is None:
            return {}
        equations = yaml_load(m.equations) if m.equations else {}
        pipes = []
        row = self.session.query_one(
            'SELECT config FROM dag WHERE project=? AND type=1 '
            'ORDER BY id DESC LIMIT 1', (m.project,))
        if row:
            cfg = yaml_load(row['config'])
            for name in (cfg.get('pipes') or {}):
                pipes.append({'name': name})
        return {
            'model': m.to_dict(),
            'pipes': pipes,
            'versions': [
                {'name': k, 'equations': v} for k, v in equations.items()
            ],
        }


__all__ = ['ModelProvider']

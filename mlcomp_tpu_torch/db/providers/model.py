"""Model registry provider — the part the trainer's score tracking
writes through (port of ``mlcomp_tpu/db/providers/model.py``; the
registry's UI queries wait for the second half of A0)."""

from mlcomp_tpu_torch.db.models import Model
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class ModelProvider(BaseDataProvider):
    model = Model

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM model WHERE name=?', (name,))
        return Model.from_row(row) if row else None


__all__ = ['ModelProvider']

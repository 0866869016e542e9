"""Auxiliary provider (port of ``mlcomp_tpu/db/providers/auxiliary.py``):
named JSON blobs, where the supervisor keeps its last tick's decision
trace."""

import json

from mlcomp_tpu_torch.db.models import Auxiliary
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class AuxiliaryProvider(BaseDataProvider):
    model = Auxiliary

    def create_or_update(self, name: str, data: dict):
        payload = json.dumps(data, default=str)
        row = self.session.query_one(
            'SELECT name FROM auxiliary WHERE name=?', (name,))
        if row is None:
            self.session.execute(
                'INSERT INTO auxiliary (name, data) VALUES (?, ?)',
                (name, payload))
        else:
            self.session.execute(
                'UPDATE auxiliary SET data=? WHERE name=?', (payload, name))

    def remove_by_name(self, name: str):
        self.session.execute(
            'DELETE FROM auxiliary WHERE name=?', (name,))

    def get(self):
        rows = self.session.query('SELECT * FROM auxiliary')
        out = {}
        for r in rows:
            try:
                out[r['name']] = json.loads(r['data'])
            except (ValueError, TypeError):
                out[r['name']] = r['data']
        return out


__all__ = ['AuxiliaryProvider']

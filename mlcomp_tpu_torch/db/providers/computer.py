"""Computer provider (port of ``mlcomp_tpu/db/providers/computer.py``,
the part the worker daemon and the file sync use; the UI's listings
wait with the API, ROADMAP.md A0)."""

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


__all__ = ['ComputerProvider']

"""Docker (runtime) provider (port of
``mlcomp_tpu/db/providers/docker.py``): the heartbeat rows whose
freshness makes a ``{computer}_{docker}`` queue live."""

import datetime

from mlcomp_tpu_torch.db.models import Docker
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class DockerProvider(BaseDataProvider):
    model = Docker

    def get(self, computer: str, name: str):
        row = self.session.query_one(
            'SELECT * FROM docker WHERE computer=? AND name=?',
            (computer, name))
        return Docker.from_row(row) if row else None

    def alive(self, window_seconds: float = 15.0):
        """Docker rows whose heartbeat is within the liveness window."""
        min_time = now() - datetime.timedelta(seconds=window_seconds)
        rows = self.session.query(
            'SELECT * FROM docker WHERE last_activity >= ?', (min_time,))
        return [Docker.from_row(r) for r in rows]

    def heartbeat(self, computer: str, name: str):
        """Upsert: the first heartbeat registers the (computer, runtime)
        pair."""
        cur = self.session.execute(
            'UPDATE docker SET last_activity=? WHERE computer=? AND name=?',
            (now(), computer, name))
        if cur.rowcount == 0:
            self.session.execute(
                'INSERT INTO docker (computer, name, last_activity) '
                'VALUES (?, ?, ?)', (computer, name, now()))


__all__ = ['DockerProvider']

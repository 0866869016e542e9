"""Serving-fleet providers (port of ``mlcomp_tpu/db/providers/fleet.py``)
— the queries the supervisor's fleet reconciler, the routing gateway and
the API/dashboard share.

Everything here is plain indexed SQL over ``serve_fleet`` /
``serve_replica`` (db/models/fleet.py): the reconciler runs inside the
1 Hz supervisor tick and the gateway's refresh thread polls every few
seconds, so each read must stay O(replicas), never O(history).
"""

from mlcomp_tpu_torch.db.models import ServeFleet, ServeReplica
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now

#: replica states that count toward the desired replica count — a
#: draining or dead replica is already being replaced/retired
LIVE_STATES = ('starting', 'healthy', 'unhealthy')


class FleetProvider(BaseDataProvider):
    model = ServeFleet

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM serve_fleet WHERE name=?', (name,))
        return ServeFleet.from_row(row) if row else None

    def active(self):
        """Fleets the reconciler must drive (anything not stopped)."""
        rows = self.session.query(
            "SELECT * FROM serve_fleet WHERE status != 'stopped'")
        return [ServeFleet.from_row(r) for r in rows]

    def touch(self, fleet, fields=None):
        fleet.updated = now()
        if fields is not None:
            fields = list(fields) + ['updated']
        self.update(fleet, fields)


class ReplicaProvider(BaseDataProvider):
    model = ServeReplica

    def of_fleet(self, fleet_id: int, generation: int = None,
                 states=None):
        sql = 'SELECT * FROM serve_replica WHERE fleet=?'
        params = [fleet_id]
        if generation is not None:
            sql += ' AND generation=?'
            params.append(int(generation))
        if states:
            sql += f' AND state IN ({",".join("?" * len(states))})'
            params += list(states)
        rows = self.session.query(sql + ' ORDER BY id', params)
        return [ServeReplica.from_row(r) for r in rows]

    def live(self, fleet_id: int, generation: int = None):
        return self.of_fleet(fleet_id, generation, states=LIVE_STATES)

    def by_task(self, task_id: int):
        row = self.session.query_one(
            'SELECT * FROM serve_replica WHERE task=? '
            'ORDER BY id DESC LIMIT 1', (task_id,))
        return ServeReplica.from_row(row) if row else None

    def set_state(self, replica, state: str, reason: str = None):
        # single-writer by architecture: every state transition runs on
        # the one supervisor tick thread (reconciler), except
        # stop_fleet's 'dead', which dominates any concurrent verdict
        # preflight: disable=db-naked-transition — see above
        replica.state = state
        replica.updated = now()
        fields = ['state', 'updated']
        if reason is not None:
            replica.failure_reason = reason
            fields.append('failure_reason')
        self.update(replica, fields)

    def mark_endpoint(self, replica_id: int, computer: str, port: int,
                      url: str):
        """The replica EXECUTOR reports where it listens (called from
        the serving process once the socket is bound)."""
        self.session.execute(
            'UPDATE serve_replica SET computer=?, port=?, url=?, '
            'updated=? WHERE id=?',
            (computer, int(port), url, now(), int(replica_id)))

    def record_probe(self, replica, ok: bool,
                     unhealthy_after: int = 3) -> bool:
        """Fold one health-probe result into the replica row. Returns
        True when this probe TRANSITIONED the replica to unhealthy
        (``unhealthy_after`` consecutive failures) — the caller's cue
        to classify and respawn. A success heals: failures reset, an
        unhealthy/starting replica becomes healthy."""
        replica.last_probe = now()
        fields = ['last_probe', 'updated']
        replica.updated = now()
        if ok:
            replica.probe_failures = 0
            replica.last_ok = now()
            fields += ['probe_failures', 'last_ok']
            if replica.state in ('starting', 'unhealthy'):
                # probes fold in on the single supervisor tick thread —
                # no concurrent writer exists for probe-driven healing
                # preflight: disable=db-naked-transition — see above
                replica.state = 'healthy'
                fields.append('state')
            self.update(replica, fields)
            return False
        replica.probe_failures = (replica.probe_failures or 0) + 1
        fields.append('probe_failures')
        flipped = False
        # 'starting' flips too: a replica that BOUND its endpoint
        # (probes only run once a URL exists) but never answers a
        # healthy probe must be classified and replaced, or it sits in
        # 'starting' forever while the pool runs below desired — only
        # endpoint-less rows are left to the task-liveness guards
        if replica.state in ('healthy', 'starting') and \
                replica.probe_failures >= int(unhealthy_after):
            # same single-writer argument as the healing branch above
            # preflight: disable=db-naked-transition — supervisor-only
            replica.state = 'unhealthy'
            fields.append('state')
            flipped = True
        self.update(replica, fields)
        return flipped

    def already_respawned(self, replica_id: int) -> bool:
        """Exactly-once respawn guard: has a replacement row already
        been minted for this dead replica?"""
        row = self.session.query_one(
            'SELECT id FROM serve_replica WHERE respawned_from=? '
            'LIMIT 1', (int(replica_id),))
        return row is not None

    def states_by_fleet(self):
        """{fleet_name: {state: count}} for /metrics and the
        dashboard's fleet card — one grouped query."""
        out = {}
        for r in self.session.query(
                'SELECT f.name AS name, r.state AS state, '
                'COUNT(*) AS n FROM serve_replica r '
                'JOIN serve_fleet f ON r.fleet = f.id '
                'GROUP BY f.name, r.state'):
            out.setdefault(r['name'], {})[r['state']] = r['n']
        return out


__all__ = ['FleetProvider', 'ReplicaProvider', 'LIVE_STATES']

"""Quota and preemption providers (port of
``mlcomp_tpu/db/providers/quota.py``): the data side of multi-tenant
scheduling (migration v15; the policy is ``server/scheduler.py``).

``QuotaProvider`` answers two questions a tick: what is tenant X's
ceiling (no row = unlimited, an explicit 0 = locked out), and how much
does X use now: live cores over its Queued/InProgress rows, billed as
the usage ledger bills, or core-seconds settled in the ledger's window.

``PreemptionProvider`` is the eviction audit trail: one row per (victim
task, attempt), recorded BEFORE the kill (conditional insert + unique
index, the ``sweep_decision`` pattern), then flipped to ``applied`` once
the kill landed. A leader killed between the two leaves an unapplied row
that the next leader's repair pass finishes; the epoch predicate of a
``FencedSession`` keeps a zombie ex-leader from recording or applying
anything.
"""

import datetime
import json

from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.models import Preemption, Quota
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now

#: what a quota row may count
QUOTA_RESOURCES = ('cores', 'core_seconds')
QUOTA_SCOPES = ('owner', 'project')


class QuotaProvider(BaseDataProvider):
    model = Quota

    def all(self):
        rows = self.session.query(
            'SELECT * FROM quota ORDER BY scope, tenant, resource')
        return [Quota.from_row(r) for r in rows]

    def get(self, scope: str, tenant: str, resource: str):
        row = self.session.query_one(
            'SELECT * FROM quota WHERE scope=? AND tenant=? '
            'AND resource=?', (scope, tenant, resource))
        return Quota.from_row(row) if row else None

    def set_quota(self, scope: str, tenant: str, resource: str,
                  limit_value: float, window_s: float = None):
        """Upsert one (scope, tenant, resource) ceiling. Validated:
        scope and resource are interpolated into queries elsewhere."""
        if scope not in QUOTA_SCOPES:
            raise ValueError(f'quota scope must be one of '
                             f'{QUOTA_SCOPES}, got {scope!r}')
        if resource not in QUOTA_RESOURCES:
            raise ValueError(f'quota resource must be one of '
                             f'{QUOTA_RESOURCES}, got {resource!r}')
        existing = self.get(scope, tenant, resource)
        if existing is None:
            self.add(Quota(
                scope=scope, tenant=str(tenant), resource=resource,
                limit_value=float(limit_value),
                window_s=float(window_s) if window_s is not None
                else 86400.0,
                created=now(), updated=now()))
            return self.get(scope, tenant, resource)
        params = [float(limit_value), now()]
        sql = 'UPDATE quota SET limit_value=?, updated=?'
        if window_s is not None:
            sql += ', window_s=?'
            params.append(float(window_s))
        sql += ' WHERE id=?'
        params.append(int(existing.id))
        self.session.execute(sql, tuple(params))
        return self.get(scope, tenant, resource)

    def delete(self, scope: str, tenant: str, resource: str) -> bool:
        cur = self.session.execute(
            'DELETE FROM quota WHERE scope=? AND tenant=? '
            'AND resource=?', (scope, tenant, resource))
        return cur.rowcount > 0

    def limit_for(self, scope: str, tenant: str, resource: str):
        """The ceiling, or None when the tenant is unlimited."""
        row = self.get(scope, tenant, resource)
        return None if row is None else float(row.limit_value or 0.0)

    # ------------------------------------------------------------ usage
    def live_cores(self, scope: str = 'owner'):
        """``{tenant: cores}`` held by Queued/InProgress tasks, billed
        like the ledger (the assigned core list, else the request). A
        gang parent whose fanned-out service rows are live is skipped:
        the children hold the cores."""
        if scope not in QUOTA_SCOPES:
            raise ValueError(f'cannot count live cores by {scope!r}')
        live = (int(TaskStatus.Queued), int(TaskStatus.InProgress))
        rows = self.session.query(
            f'SELECT t.id, COALESCE(t.{scope}, ?) AS tenant, '
            f't.cores_assigned, t.cores, '
            f'(SELECT COUNT(*) FROM task c WHERE c.parent = t.id '
            f' AND c.status IN (?, ?)) AS live_children '
            f'FROM task t WHERE t.status IN (?, ?)',
            ('default', *live, *live))
        out = {}
        for r in rows:
            if r['live_children']:
                continue
            cores = int(r['cores'] or 0)
            if r['cores_assigned']:
                try:
                    cores = len(json.loads(r['cores_assigned']))
                except (ValueError, TypeError):
                    pass
            if cores:
                out[r['tenant']] = out.get(r['tenant'], 0) + cores
        return out

    def window_core_seconds(self, scope: str = 'owner',
                            window_s: float = 86400.0):
        """``{tenant: core_seconds}`` settled in the ledger inside the
        window: the fair-share weight's usage side."""
        if scope not in QUOTA_SCOPES:
            raise ValueError(f'cannot window usage by {scope!r}')
        if not self.session.table_columns('usage'):
            return {}
        cutoff = now() - datetime.timedelta(seconds=float(window_s))
        rows = self.session.query(
            f'SELECT COALESCE({scope}, ?) AS tenant, '
            f'SUM(core_seconds) AS cs FROM usage '
            f'WHERE COALESCE(finished, created) >= ? '
            f'GROUP BY COALESCE({scope}, ?)',
            ('default', cutoff, 'default'))
        return {r['tenant']: float(r['cs'] or 0.0) for r in rows}


    def all_with_usage(self):
        """``[(quota, used)]``: each ceiling beside the usage admission
        measures against it (live cores, or core-seconds in its window);
        what ``/api/quotas`` and ``mlcomp_quota_usage`` show."""
        cache, out = {}, []
        for q in self.all():
            if q.resource == 'cores':
                key = ('live', q.scope)
                if key not in cache:
                    cache[key] = self.live_cores(q.scope)
                out.append((q, cache[key].get(q.tenant, 0)))
                continue
            window = float(q.window_s or 86400.0)
            key = ('window', q.scope, window)
            if key not in cache:
                cache[key] = self.window_core_seconds(q.scope, window)
            out.append((q, cache[key].get(q.tenant, 0.0)))
        return out


class PreemptionProvider(BaseDataProvider):
    model = Preemption

    def record(self, victim, initiator, reason: str, cores_freed: int,
               epoch, victim_class: str = None,
               initiator_class: str = None) -> bool:
        """Record one eviction decision EXACTLY ONCE, before the kill:
        conditional on no row for the same (victim task, attempt),
        backstopped by the v15 unique index and epoch-fenced through a
        ``FencedSession``. True when THIS call recorded it."""
        cur = self.session.execute(
            'INSERT INTO preemption '
            '(task, attempt, victim_class, gang_id, initiator, '
            'initiator_class, reason, computer, cores_freed, applied, '
            'epoch, time) '
            'SELECT ?, ?, ?, ?, ?, ?, ?, ?, ?, 0, ?, ? '
            'WHERE NOT EXISTS (SELECT 1 FROM preemption '
            'WHERE task=? AND attempt=?)',
            (int(victim.id), int(victim.attempt or 0), victim_class,
             getattr(victim, 'gang_id', None),
             None if initiator is None else int(initiator.id),
             initiator_class, reason,
             getattr(victim, 'computer_assigned', None),
             int(cores_freed or 0), int(epoch or 0), now(),
             int(victim.id), int(victim.attempt or 0)))
        return cur.rowcount > 0

    def mark_applied(self, task_id: int, attempt: int) -> bool:
        """Flip the decision to applied exactly once."""
        cur = self.session.execute(
            'UPDATE preemption SET applied=1 '
            'WHERE task=? AND attempt=? AND applied=0',
            (int(task_id), int(attempt or 0)))
        return cur.rowcount > 0

    def unapplied(self, limit: int = 100):
        """Recorded but unapplied decisions: the repair worklist."""
        rows = self.session.query(
            'SELECT * FROM preemption WHERE applied=0 '
            'ORDER BY id LIMIT ?', (int(limit),))
        return [Preemption.from_row(r) for r in rows]

    def recent(self, limit: int = 50):
        rows = self.session.query(
            'SELECT * FROM preemption ORDER BY id DESC LIMIT ?',
            (int(limit),))
        return [Preemption.from_row(r) for r in rows]

    def for_task(self, task_id: int):
        rows = self.session.query(
            'SELECT * FROM preemption WHERE task=? ORDER BY attempt',
            (int(task_id),))
        return [Preemption.from_row(r) for r in rows]

    def count(self) -> int:
        row = self.session.query_one(
            'SELECT COUNT(*) AS n FROM preemption')
        return row['n'] if row else 0


__all__ = ['QuotaProvider', 'PreemptionProvider', 'QUOTA_RESOURCES',
           'QUOTA_SCOPES']

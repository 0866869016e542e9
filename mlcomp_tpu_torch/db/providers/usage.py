"""Usage-ledger provider (port of ``mlcomp_tpu/db/providers/usage.py``):
exactly-once folds and grouped aggregation.

The supervisor calls ``fold_task`` for every terminal task attempt, and
migration v14 once per attempt already terminal when it runs. The insert
is conditional on no row for the same (task, attempt): one statement,
race-safe, backstopped by the v14 unique index ``idx_usage_once`` (the
``sweep_decision`` pattern). Through a ``FencedSession`` the statement
also carries the leader's epoch, so a zombie ex-leader never bills an
attempt twice across a failover.

``aggregate`` is the read side: GROUP BYs over the settled rows, what
``/api/usage`` and the ``usage`` command serve.
"""

import json

from mlcomp_tpu_torch.db.core import parse_datetime
from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.models import Usage
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.server.scheduler import task_class_of
from mlcomp_tpu_torch.utils.misc import now


class UsageProvider(BaseDataProvider):
    model = Usage

    # ------------------------------------------------------------ fold
    def fold_task(self, task) -> bool:
        """Fold one terminal task attempt into the ledger EXACTLY ONCE;
        True when THIS call wrote the row. Facts come from the row at
        fold time: core-seconds (billed cores x started->finished),
        queue wait (enqueue->claim of its message, None when unknowable)
        and peak HBM (MAX over ``device*.hbm_used``, None for
        uninstrumented tasks)."""
        started = parse_datetime(task.started)
        finished = parse_datetime(task.finished)
        cores = self._billed_cores(task)
        core_seconds = None
        if started and finished and finished >= started:
            core_seconds = cores * (finished - started).total_seconds()
        cur = self.session.execute(
            'INSERT INTO usage '
            '(task, attempt, dag, owner, project, task_class, computer, '
            'cores, core_seconds, queue_wait_s, hbm_peak_bytes, '
            'started, finished, status, created) '
            'SELECT ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ? '
            'WHERE NOT EXISTS (SELECT 1 FROM usage '
            'WHERE task=? AND attempt=?)',
            (int(task.id), int(task.attempt or 0), task.dag,
             getattr(task, 'owner', None) or 'default',
             getattr(task, 'project', None) or 'default',
             task_class_of(task), task.computer_assigned, cores,
             core_seconds, self.queue_wait(task), self.hbm_peak(task.id),
             task.started, task.finished, int(task.status), now(),
             int(task.id), int(task.attempt or 0)))
        return cur.rowcount > 0

    @staticmethod
    def _billed_cores(task) -> int:
        """The assigned core list's length, else the requested cores."""
        assigned = getattr(task, 'cores_assigned', None)
        if assigned:
            try:
                return len(json.loads(assigned))
            except (ValueError, TypeError):
                pass
        return int(task.cores or 0)

    def queue_wait(self, task):
        """enqueue->claim seconds of the task's queue message, or None
        (no message, never claimed, aged out, or a legacy DB without the
        table: the fold degrades per fact, it never skips the row)."""
        if not getattr(task, 'queue_id', None):
            return None
        if not self.session.table_columns('queue_message'):
            return None
        row = self.session.query_one(
            'SELECT created, claimed_at FROM queue_message WHERE id=?',
            (int(task.queue_id),))
        if row is None:
            return None
        created = parse_datetime(row['created'])
        claimed = parse_datetime(row['claimed_at'])
        if created is None or claimed is None or claimed < created:
            return None
        return (claimed - created).total_seconds()

    def hbm_peak(self, task_id: int):
        """Peak HBM bytes across every device of a task, or None for an
        uninstrumented task (or a legacy DB without the metric table)."""
        if not self.session.table_columns('metric'):
            return None
        row = self.session.query_one(
            "SELECT MAX(value) AS peak FROM metric "
            "WHERE task=? AND name LIKE 'device%.hbm_used'",
            (int(task_id),))
        return row['peak'] if row else None

    def unfolded_terminal_tasks(self, limit: int = 500):
        """Terminal task rows with no ledger row for their current
        attempt: the per-tick fold worklist (settled history drops out
        of the anti-join)."""
        from mlcomp_tpu_torch.db.models import Task
        finished = TaskStatus.finished()
        marks = ','.join('?' * len(finished))
        rows = self.session.query(
            f'SELECT t.* FROM task t WHERE t.status IN ({marks}) '
            f'AND NOT EXISTS (SELECT 1 FROM usage u WHERE u.task=t.id '
            f'AND u.attempt=COALESCE(t.attempt, 0)) '
            f'ORDER BY t.id LIMIT ?',
            tuple(int(s) for s in finished) + (int(limit),))
        return [Task.from_row(r) for r in rows]

    # ------------------------------------------------------------ reads
    def aggregate(self, group_by: str = 'owner'):
        """Grouped totals ``[{key, tasks, core_seconds,
        queue_wait_s_total, queue_wait_s_max, hbm_peak_bytes}]``,
        core-seconds descending. ``group_by`` is one of owner | project |
        task_class | computer (validated: it is interpolated into SQL)."""
        if group_by not in ('owner', 'project', 'task_class', 'computer'):
            raise ValueError(f'cannot group usage by {group_by!r}')
        rows = self.session.query(
            f'SELECT {group_by} AS key, COUNT(*) AS tasks, '
            f'SUM(core_seconds) AS core_seconds, '
            f'SUM(queue_wait_s) AS queue_wait_s_total, '
            f'MAX(queue_wait_s) AS queue_wait_s_max, '
            f'MAX(hbm_peak_bytes) AS hbm_peak_bytes '
            f'FROM usage GROUP BY {group_by} '
            f'ORDER BY SUM(core_seconds) DESC, key')
        return [{'key': r['key'], 'tasks': r['tasks'],
                 'core_seconds': r['core_seconds'],
                 'queue_wait_s_total': r['queue_wait_s_total'],
                 'queue_wait_s_max': r['queue_wait_s_max'],
                 'hbm_peak_bytes': r['hbm_peak_bytes']}
                for r in rows]

    def recent(self, limit: int = 100, owner: str = None,
               project: str = None):
        """Newest ledger rows, optionally filtered by label."""
        where, params = [], []
        if owner is not None:
            where.append('owner=?')
            params.append(owner)
        if project is not None:
            where.append('project=?')
            params.append(project)
        sql = 'SELECT * FROM usage'
        if where:
            sql += ' WHERE ' + ' AND '.join(where)
        sql += ' ORDER BY id DESC LIMIT ?'
        params.append(int(limit))
        return [Usage.from_row(r)
                for r in self.session.query(sql, tuple(params))]

    def count(self) -> int:
        row = self.session.query_one('SELECT COUNT(*) AS n FROM usage')
        return row['n'] if row else 0


__all__ = ['UsageProvider', 'task_class_of']

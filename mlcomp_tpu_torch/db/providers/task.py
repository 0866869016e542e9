"""Task provider (port of ``mlcomp_tpu/db/providers/task.py``, the part
the builder, the pipeline, ``execute``, the supervisor and the worker
daemon use): ``dependency_status`` (which dependencies of each task are
in which status), ``parent_tasks_stats`` (child statuses of distributed
parents), ``children``, ``by_status``, the ``change_status`` transition
bookkeeping and ``fail_with_reason``, and the API's task listing
(``get``).
"""

import json

from mlcomp_tpu_torch.db.enums import TaskStatus, TaskType
from mlcomp_tpu_torch.db.events import CH_TASKS
from mlcomp_tpu_torch.db.models import Task, TaskDependence
from mlcomp_tpu_torch.db.providers.base import (
    BaseDataProvider, PaginatorOptions,
)
from mlcomp_tpu_torch.utils.misc import now


class TaskProvider(BaseDataProvider):
    model = Task

    def _publish_tasks(self):
        """Wake the supervisor: a new or transitioned task row may be
        schedulable (or may unblock dependents) right now. Best-effort
        — a lost wakeup costs one backstop interval, not correctness."""
        try:
            self.session.publish_event(CH_TASKS)
        except Exception:
            pass

    def add(self, obj, commit: bool = True):
        obj = super().add(obj, commit=commit)
        # Task rows only: dependence edges ride through this same
        # add() (add_dependency) and waking — on Postgres, one
        # pg_notify round trip — per EDGE would double a submit's
        # publish cost for wakeups the task-row publishes already
        # delivered
        if isinstance(obj, Task):
            self._publish_tasks()
        return obj

    # --------------------------------------------------------- dependencies
    def add_dependency(self, task_id: int, depend_id: int):
        self.add(TaskDependence(task_id=task_id, depend_id=depend_id))

    def dependency_status(self, task_ids):
        """task_id -> set of statuses of its dependencies
        (reference db/providers/task.py:194-203)."""
        if not task_ids:
            return {}
        marks = ','.join('?' * len(task_ids))
        rows = self.session.query(
            f'SELECT td.task_id AS task_id, t.status AS status '
            f'FROM task_dependence td JOIN task t ON td.depend_id = t.id '
            f'WHERE td.task_id IN ({marks})', tuple(task_ids))
        res = {tid: set() for tid in task_ids}
        for r in rows:
            res[r['task_id']].add(r['status'])
        return res

    def dependencies(self, task_id: int):
        rows = self.session.query(
            'SELECT t.* FROM task_dependence td '
            'JOIN task t ON td.depend_id = t.id WHERE td.task_id=?',
            (task_id,))
        return [Task.from_row(r) for r in rows]

    def children(self, parent_id: int, statuses=None):
        sql = 'SELECT * FROM task WHERE parent=?'
        params = [parent_id]
        if statuses:
            sql += f' AND status IN ({",".join("?" * len(statuses))})'
            params += [int(s) for s in statuses]
        return [Task.from_row(r) for r in self.session.query(sql, params)]

    def parent_tasks_stats(self):
        """For each unfinished parent task its children grouped by
        status: a list of (parent_task, started, finished,
        {status: count}), in two set queries."""
        unfinished = [int(s) for s in TaskStatus.unfinished()]
        marks = ','.join('?' * len(unfinished))
        parents = [Task.from_row(p) for p in self.session.query(
            f'SELECT * FROM task WHERE status IN ({marks}) AND id IN '
            f'(SELECT DISTINCT parent FROM task WHERE parent IS NOT NULL)',
            tuple(unfinished))]
        if not parents:
            return []
        id_marks = ','.join('?' * len(parents))
        rows = self.session.query(
            f'SELECT parent, status, COUNT(*) AS c, MIN(started) AS s, '
            f'MAX(finished) AS f FROM task WHERE parent IN ({id_marks}) '
            f'GROUP BY parent, status',
            tuple(p.id for p in parents))
        by_parent = {}
        for r in rows:
            by_parent.setdefault(r['parent'], []).append(r)
        res = []
        for parent in parents:
            grouped = by_parent.get(parent.id, [])
            stats = {r['status']: r['c'] for r in grouped}
            started = min((r['s'] for r in grouped if r['s']),
                          default=None)
            finished = max((r['f'] for r in grouped if r['f']),
                           default=None)
            res.append((parent, started, finished, stats))
        return res

    # -------------------------------------------------------------- status
    def change_status(self, task, status: TaskStatus):
        # the transition is guarded at every call site instead of here:
        # the worker refuses to execute a task that is not Queued, the
        # supervisor's tick is the only writer for scheduling states,
        # and kill paths go through the queue's conditional claim.
        # Folding a prior-status condition in here needs expected-state
        # plumbing at ~30 call sites — revisit with the PostgreSQL
        # backend (ROADMAP.md, "Not queueable without a download"),
        # where cross-host writers make the call-site guards
        # insufficient.
        # preflight: disable=db-naked-transition — see above
        task.status = int(status)
        fields = ['status', 'started', 'finished', 'last_activity']
        if status == TaskStatus.InProgress:
            task.started = now()
        elif status in TaskStatus.finished():
            if task.started is None:
                task.started = now()
            task.finished = now()
            if status == TaskStatus.Success:
                # a succeeded task carries no failure verdict — a stale
                # reason from a retried-and-recovered attempt would
                # read as a live problem in the UI
                task.failure_reason = None
                fields.append('failure_reason')
        task.last_activity = now()
        self.update(task, fields)
        # a finished/failed/skipped transition may unblock dependents
        # or free capacity — wake the supervisor instead of letting it
        # sleep out its backstop
        if status in TaskStatus.finished() or \
                status == TaskStatus.NotRan:
            self._publish_tasks()

    def fail_with_reason(self, task, reason: str):
        """Mark Failed with a recovery-taxonomy reason
        (mlcomp_tpu_torch/recovery.py) — the supervisor's retry pass reads
        ``failure_reason`` to decide transient-vs-permanent. Every
        failure site should come through here; a bare Failed (no
        reason) is never retried.

        This is also the flight recorder's choke point: every reasoned
        failure freezes a postmortem bundle (telemetry/memory.py) — the
        last steps of the loss/phase/memory/compile series plus the run
        snapshot — into the ``postmortem`` table. Worker-side failures
        flushed their telemetry before reaching here (the executor's
        teardown, the crash flush). Best-effort by construction: the
        recorder never breaks the failure path it rides."""
        task.failure_reason = reason
        self.update(task, ['failure_reason'])
        self.change_status(task, TaskStatus.Failed)
        try:
            from mlcomp_tpu_torch.telemetry.memory import persist_postmortem
            persist_postmortem(self.session, task.id, reason=reason)
        except Exception:
            pass

    def by_status(self, *statuses, computer: str = None):
        marks = ','.join('?' * len(statuses))
        sql = f'SELECT * FROM task WHERE status IN ({marks})'
        params = [int(s) for s in statuses]
        if computer is not None:
            sql += ' AND computer_assigned=?'
            params.append(computer)
        return [Task.from_row(r) for r in self.session.query(sql, params)]

    def update_last_activity(self, task_id: int):
        self.session.execute(
            'UPDATE task SET last_activity=? WHERE id=?', (now(), task_id))

    def by_dag(self, dag_id: int):
        rows = self.session.query(
            'SELECT * FROM task WHERE dag=?', (dag_id,))
        return [Task.from_row(r) for r in rows]

    def get(self, filter: dict = None, options: PaginatorOptions = None):
        filter = filter or {}
        where, params = [], []
        if filter.get('dag'):
            where.append('t.dag=?')
            params.append(filter['dag'])
        if filter.get('name'):
            where.append('t.name LIKE ?')
            params.append(f"%{filter['name']}%")
        if filter.get('status') is not None:
            statuses = filter['status']
            if isinstance(statuses, list) and statuses:
                where.append(
                    f't.status IN ({",".join("?" * len(statuses))})')
                params += statuses
        if filter.get('project'):
            where.append('d.project=?')
            params.append(filter['project'])
        if filter.get('type') is not None:
            types = filter['type']
            if not isinstance(types, list):
                types = [types]
            where.append(f't.type IN ({",".join("?" * len(types))})')
            params += types
        if filter.get('id'):
            where.append('t.id=?')
            params.append(filter['id'])
        if not filter.get('show_service', False):
            where.append('t.type != ?')
            params.append(int(TaskType.Service))

        where_sql = (' WHERE ' + ' AND '.join(where)) if where else ''
        options = options or PaginatorOptions()
        sort = options.sort_column or 'id'
        if sort not in Task.__columns__:
            sort = 'id'
        direction = 'DESC' if options.sort_descending else 'ASC'
        offset = options.page_number * options.page_size
        rows = self.session.query(
            f'SELECT t.*, d.name AS dag_name FROM task t '
            f'JOIN dag d ON t.dag = d.id{where_sql} '
            f'ORDER BY t."{sort}" {direction} LIMIT ? OFFSET ?',
            tuple(params) + (options.page_size, offset))
        total = self.session.query_one(
            f'SELECT COUNT(*) AS c FROM task t '
            f'JOIN dag d ON t.dag = d.id{where_sql}', tuple(params))['c']
        data = []
        for r in rows:
            item = Task.from_row(r).to_dict()
            item['dag_name'] = r['dag_name']
            if item.get('cores_assigned'):
                try:
                    item['cores_assigned'] = json.loads(
                        item['cores_assigned'])
                except (ValueError, TypeError):
                    pass
            data.append(item)
        return {'total': total, 'data': data}


__all__ = ['TaskProvider']

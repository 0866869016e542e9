"""TaskSynced provider (port of
``mlcomp_tpu/db/providers/task_synced.py``): the ledger of successful
tasks whose data a computer has pulled."""

from mlcomp_tpu_torch.db.enums import TaskStatus
from mlcomp_tpu_torch.db.models import Task, TaskSynced
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class TaskSyncedProvider(BaseDataProvider):
    model = TaskSynced

    def for_computer(self, computer: str):
        """Successful tasks that ran elsewhere and are not yet pulled to
        ``computer``: [(source computer, project_id, [tasks])]."""
        rows = self.session.query(
            'SELECT t.*, d.project AS project_id FROM task t '
            'JOIN dag d ON t.dag = d.id '
            'WHERE t.status=? AND t.computer_assigned IS NOT NULL '
            'AND t.computer_assigned != ? AND t.id NOT IN '
            '(SELECT task FROM task_synced WHERE computer=?)',
            (int(TaskStatus.Success), computer, computer))
        grouped = {}
        for r in rows:
            key = (r['computer_assigned'], r['project_id'])
            grouped.setdefault(key, []).append(Task.from_row(r))
        return [(src, project, tasks)
                for (src, project), tasks in grouped.items()]

    def mark_synced(self, computer: str, task_id: int):
        self.add(TaskSynced(computer=computer, task=task_id))


__all__ = ['TaskSyncedProvider']

"""Step provider — step-tree builder (parity: reference db/providers/step.py:9-80)."""

from mlcomp_tpu_torch.db.models import Step
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class StepProvider(BaseDataProvider):
    model = Step

    def by_task(self, task_id: int):
        rows = self.session.query(
            'SELECT * FROM step WHERE task=? ORDER BY started, id',
            (task_id,))
        return [Step.from_row(r) for r in rows]

    def unfinished(self, task_id: int):
        rows = self.session.query(
            'SELECT * FROM step WHERE task=? AND finished IS NULL '
            'ORDER BY level', (task_id,))
        return [Step.from_row(r) for r in rows]

    def get(self, task_id: int):
        """Hierarchical step tree with per-step log counts
        (reference step.py:12-80)."""
        steps = self.by_task(task_id)
        log_counts = {}
        for r in self.session.query(
                'SELECT step, level, COUNT(*) AS c FROM log WHERE task=? '
                'AND step IS NOT NULL GROUP BY step, level', (task_id,)):
            log_counts.setdefault(r['step'], {})[r['level']] = r['c']

        nodes = []
        stack = []
        for s in steps:
            node = s.to_dict()
            node['children'] = []
            node['log_statuses'] = [
                {'name': name, 'count': log_counts.get(s.id, {}).get(lv, 0)}
                for lv, name in ((0, 'Debug'), (1, 'Info'),
                                 (2, 'Warning'), (3, 'Error'))
            ]
            while stack and stack[-1]['level'] >= s.level:
                stack.pop()
            if stack:
                stack[-1]['children'].append(node)
            else:
                nodes.append(node)
            stack.append(node)
        return nodes


__all__ = ['StepProvider']

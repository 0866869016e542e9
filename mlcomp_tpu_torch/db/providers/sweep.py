"""Sweep providers (port of ``mlcomp_tpu/db/providers/sweep.py``) —
the queries the supervisor's ASHA scheduler, the API/dashboard roster
and the /metrics collectors share.

Everything is indexed SQL over ``sweep`` / ``sweep_decision``
(db/models/sweep.py) plus grouped reads over the cell task rows; the
scheduler runs inside the supervisor tick, so each read must stay
O(cells + decisions), never O(metric history) — the one metric read
(rung reports) is an indexed ``(task, name)`` scan bounded by the
cells' own report cadence.
"""

from mlcomp_tpu_torch.db.models import Sweep, SweepDecision
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now


class SweepProvider(BaseDataProvider):
    model = Sweep

    def active(self):
        rows = self.session.query(
            "SELECT * FROM sweep WHERE status='active' ORDER BY id")
        return [Sweep.from_row(r) for r in rows]

    def by_dag(self, dag_id: int):
        rows = self.session.query(
            'SELECT * FROM sweep WHERE dag=? ORDER BY id', (dag_id,))
        return [Sweep.from_row(r) for r in rows]

    def cell_tasks(self, sweep):
        """The sweep's cell rows: the grid fan-out of (dag, executor).
        Parent rows only — a distributed cell's service ranks belong
        to the cell, they are not cells themselves."""
        from mlcomp_tpu_torch.db.models import Task
        rows = self.session.query(
            'SELECT * FROM task WHERE dag=? AND executor=? '
            'AND parent IS NULL ORDER BY id',
            (int(sweep.dag), sweep.executor))
        return [Task.from_row(r) for r in rows]

    def rung_reports(self, task_ids):
        """``{task_id: [(budget, value), ...]}`` ascending by budget —
        every ``sweep.score`` report the cells have emitted. One
        indexed IN-scan; the per-cell series is bounded by the report
        cadence (one row per epoch boundary)."""
        from mlcomp_tpu_torch.contrib.search.asha import (
            SWEEP_SCORE_METRIC,
        )
        task_ids = [int(t) for t in task_ids]
        if not task_ids:
            return {}
        marks = ','.join('?' * len(task_ids))
        rows = self.session.query(
            f'SELECT task, step, value FROM metric '
            f'WHERE name=? AND task IN ({marks}) '
            f'ORDER BY task, step, id',
            (SWEEP_SCORE_METRIC, *task_ids))
        out = {}
        for r in rows:
            if r['step'] is None or r['value'] is None:
                continue
            out.setdefault(r['task'], []).append(
                (int(r['step']), float(r['value'])))
        return out


class SweepDecisionProvider(BaseDataProvider):
    model = SweepDecision

    def for_sweep(self, sweep_id: int):
        rows = self.session.query(
            'SELECT * FROM sweep_decision WHERE sweep=? '
            'ORDER BY rung, id', (int(sweep_id),))
        return [SweepDecision.from_row(r) for r in rows]

    def record(self, sweep_id: int, task_id: int, rung: int,
               verdict: str, score, cutoff, cells_seen: int,
               epoch) -> bool:
        """Record one (cell, rung) verdict EXACTLY ONCE. The insert is
        conditional on no existing decision for the same (sweep, task,
        rung) — race-safe as a single statement on both backends, and
        the v13 unique index backstops it. Through a FencedSession the
        statement additionally carries the leader's epoch predicate,
        so a zombie ex-leader's verdict is rejected in the store.
        Returns True when THIS call recorded the decision."""
        cur = self.session.execute(
            'INSERT INTO sweep_decision '
            '(sweep, task, rung, verdict, score, cutoff, cells_seen, '
            'epoch, time) '
            'SELECT ?, ?, ?, ?, ?, ?, ?, ?, ? '
            'WHERE NOT EXISTS (SELECT 1 FROM sweep_decision '
            'WHERE sweep=? AND task=? AND rung=?)',
            (int(sweep_id), int(task_id), int(rung), verdict,
             None if score is None else float(score),
             None if cutoff is None else float(cutoff),
             int(cells_seen), int(epoch or 0), now(),
             int(sweep_id), int(task_id), int(rung)))
        return cur.rowcount > 0

    def decided(self, sweep_id: int):
        """``{(task, rung): verdict}`` for one sweep — the judge
        loop's skip set, one indexed read per tick."""
        rows = self.session.query(
            'SELECT task, rung, verdict FROM sweep_decision '
            'WHERE sweep=?', (int(sweep_id),))
        return {(r['task'], r['rung']): r['verdict'] for r in rows}


__all__ = ['SweepProvider', 'SweepDecisionProvider']

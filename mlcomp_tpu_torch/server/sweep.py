"""ASHA sweep scheduler — early-stopping hyperparameter search as a
supervisor policy (port of ``mlcomp_tpu/server/sweep.py``).

The grid executor fans a swept spec into cell tasks; every cell
reports its metric at epoch boundaries (``sweep.score`` rows, the
contract in contrib/search/asha.py). This scheduler runs inside the
supervisor tick (``process_sweeps``, BEFORE ``load_tasks`` so a freed
slot re-places into the next queued cell in the SAME tick) and, per
asynchronous successive halving, judges each cell the moment it
reports a budget rung — no rung barrier:

- the cell's score at rung ``r`` is compared against the running
  top-``1/eta`` quantile of every score recorded at that rung so far
  (``min_cells_per_rung`` guards the degenerate early population);
- losers are pruned through the existing kill path: the verdict is
  recorded FIRST (``sweep_decision`` row, conditional insert = exactly
  once), then the cell is Failed with the **non-retryable** taxonomy
  reason ``sweep-pruned`` and its process/queue message killed/revoked
  via ``kill_task``. Recording before killing means a leader crash
  mid-prune leaves an auditable verdict a promoted standby completes
  (the repair pass below) — never a silently-killed cell or a
  double-recorded one;
- every write rides the supervisor's FencedSession: a zombie ex-leader
  can neither record a verdict nor apply one (db/fencing.py).

Promotion is implicit and checkpoint-aware: a promoted cell simply
keeps training (the train loop checkpoints at rung boundaries, so a
promoted cell that later dies transiently resumes from its rung
checkpoint through the ordinary retry path). A ``promote`` decision
row is still recorded per rung — the audit trail answers "why is this
cell still running" as well as "why was that one killed".
"""

import traceback

from mlcomp_tpu_torch.contrib.search.asha import (
    promote_cutoff, rung_boundaries,
    score_at_rung,
)
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.fencing import FenceLostError
from mlcomp_tpu_torch.db.models import Sweep
from mlcomp_tpu_torch.db.providers import (
    SweepDecisionProvider, SweepProvider, TaskProvider,
)
from mlcomp_tpu_torch.testing.faults import fault_point
from mlcomp_tpu_torch.utils.misc import now

#: the non-retryable taxonomy reason a pruned cell carries — NOT in
#: recovery.TRANSIENT_REASONS, so the retry pass's SQL filter never
#: loads it and the watchdog's finished-task handling leaves it be
SWEEP_PRUNED_REASON = 'sweep-pruned'

#: task statuses a prune still has something to stop
_LIVE = (int(TaskStatus.NotRan), int(TaskStatus.Queued),
         int(TaskStatus.InProgress))


def create_sweep(session, dag, executor_name: str, norm: dict,
                 n_cells: int) -> Sweep:
    """Persist one sweep row at submission. ``norm`` is the ALREADY
    normalized ``sweep:`` block (normalize_sweep_spec's output — one
    normalization per submission, so the spec stamped into the cells
    and the row the scheduler judges from can never diverge)."""
    sweep = Sweep(
        dag=dag.id, executor=executor_name,
        name=f'{dag.name}/{executor_name}',
        metric=norm['metric'], mode=norm['mode'], eta=norm['eta'],
        rung_base=norm['base'], unit=norm['unit'],
        min_cells_per_rung=norm['min_cells_per_rung'],
        cells=int(n_cells), status='active', created=now(),
        updated=now())
    SweepProvider(session).add(sweep)
    return sweep


class SweepScheduler:
    """Per-tick ASHA pass over every active sweep. Constructed by the
    SupervisorBuilder with ITS session (fenced under HA), its logger
    and its tick recorder (``telemetry``: each prune counts into
    ``supervisor.sweep_pruned``); ``gang_abort`` is the builder's
    gang-abort sweep so pruning a DISTRIBUTED cell kills its fanned-out
    ranks in the same tick instead of leaving them at a dead
    collective."""

    def __init__(self, session, logger=None, telemetry=None,
                 gang_abort=None):
        self.session = session
        self.logger = logger
        self.telemetry = telemetry
        self.gang_abort = gang_abort
        self.provider = TaskProvider(session)
        self.sweeps = SweepProvider(session)
        self.decisions = SweepDecisionProvider(session)
        # judge-pass short-circuit: the newest sweep.score metric id
        # seen. Reports only ever append, so an unmoved watermark
        # means no rung can have new scores — the tick then skips the
        # report materialization (a big sweep's whole score history)
        # and runs only the cheap repair/finish reads. None = judge
        # on the first tick regardless.
        self._report_watermark = None

    def _score_watermark(self):
        from mlcomp_tpu_torch.contrib.search.asha import SWEEP_SCORE_METRIC
        row = self.session.query_one(
            'SELECT MAX(id) AS m FROM metric WHERE name=?',
            (SWEEP_SCORE_METRIC,))
        return row['m'] if row else None

    # ------------------------------------------------------------------ tick
    def tick(self) -> dict:
        aux = {}
        sweeps = self.sweeps.active()
        if not sweeps:
            return aux
        try:
            mark = self._score_watermark()
        except Exception:
            mark = None
        judge = self._report_watermark is None \
            or mark != self._report_watermark
        all_ok = True
        for sweep in sweeps:
            try:
                entry = self._tick_sweep(sweep, judge=judge)
                if entry:
                    aux[sweep.id] = entry
            except FenceLostError:
                raise       # zombie leader: stop the tick, demote
            except Exception:
                all_ok = False
                if self.logger:
                    self.logger.error(
                        f'sweep {sweep.id} ({sweep.name}) tick '
                        f'failed:\n{traceback.format_exc()}',
                        ComponentType.Supervisor)
        # advance the judge watermark only on a fully clean pass: a
        # sweep whose tick crashed (transient DB hiccup) must be
        # re-judged next tick, not parked until some FUTURE report
        # happens to move MAX(id)
        self._report_watermark = mark if all_ok else None
        return aux

    def _tick_sweep(self, sweep: Sweep, judge: bool = True) -> dict:
        cells = self.sweeps.cell_tasks(sweep)
        if not cells:
            return {}
        entry = {}
        by_id = {c.id: c for c in cells}
        decided = self.decisions.decided(sweep.id)
        # repair pass: a verdict recorded by a leader that died before
        # applying it (chaos seam below sits between the two) — the
        # promoted standby finishes the kill, exactly once, because
        # the DECISION is the once-guard and the apply is idempotent
        for (task_id, rung), verdict in decided.items():
            cell = by_id.get(task_id)
            if verdict == 'prune' and cell is not None \
                    and cell.status in _LIVE:
                self._apply_prune(sweep, cell, rung)
                entry.setdefault('repaired', []).append(task_id)
        judged = 0
        if judge:
            reports = self.sweeps.rung_reports(list(by_id))
            judged = self._judge(sweep, cells, reports, decided, entry)
        self._maybe_finish(sweep, cells, entry)
        if judged or entry:
            entry.setdefault('cells', len(cells))
        return entry

    # ----------------------------------------------------------------- judge
    def _judge(self, sweep, cells, reports, decided, entry) -> int:
        """The async-ASHA core: walk rungs ascending; at each rung,
        every not-yet-judged LIVE cell whose reports reached the
        boundary is compared against ALL scores recorded at that rung
        so far (terminal and pruned cells included — their reports
        stay part of the population, which is what makes the running
        quantile consistent no matter the arrival order)."""
        eta, mode = float(sweep.eta or 2.0), sweep.mode or 'max'
        max_budget = max((r[-1][0] for r in reports.values() if r),
                         default=0)
        judged = 0
        pruned_now = set()
        for rung, boundary in enumerate(rung_boundaries(
                int(sweep.rung_base or 1), eta, max_budget)):
            at_rung = {}            # task_id -> score at this rung
            for cell in cells:
                score = score_at_rung(reports.get(cell.id) or [],
                                      boundary)
                if score is not None:
                    at_rung[cell.id] = score
            if len(at_rung) < int(sweep.min_cells_per_rung or 2):
                # the guard: a quantile over one straggler would prune
                # on noise. Higher rungs have fewer reporters still.
                break
            scores = list(at_rung.values())
            # one sort per rung, not per cell: the cutoff is invariant
            # across the cell loop (judge() compares against it)
            cutoff = promote_cutoff(scores, eta, mode)
            for cell in cells:
                if cell.id not in at_rung or cell.id in pruned_now \
                        or (cell.id, rung) in decided \
                        or cell.status not in _LIVE:
                    continue
                score = at_rung[cell.id]
                ok = score >= cutoff if mode == 'max' \
                    else score <= cutoff
                verdict = 'promote' if ok else 'prune'
                epoch = getattr(self.session, 'fence_epoch', None)
                if not self.decisions.record(
                        sweep.id, cell.id, rung, verdict, score,
                        cutoff, len(scores), epoch):
                    continue    # raced double tick: the other won
                decided[(cell.id, rung)] = verdict
                judged += 1
                entry.setdefault(verdict + 'd', []).append(
                    {'task': cell.id, 'rung': rung,
                     'score': round(score, 6),
                     'cutoff': round(cutoff, 6), 'of': len(scores)})
                if verdict == 'prune':
                    # chaos seam: a leader SIGKILL'd HERE has recorded
                    # the verdict but not applied it — the standby's
                    # repair pass must finish it exactly once
                    fault_point('sweep.prune', sweep=sweep.id,
                                task=cell.id, rung=rung)
                    self._apply_prune(sweep, cell, rung)
                    pruned_now.add(cell.id)
        return judged

    # ----------------------------------------------------------------- prune
    def _apply_prune(self, sweep, cell, rung: int):
        """Kill one judged loser through the existing taxonomy path.
        Failed-with-reason FIRST (kill_task never downgrades a Failed
        status, and a remote-routed kill lands after this tick); the
        reason is non-retryable by construction, so the recovery pass
        never resurrects a pruned cell. Distributed cells gang-abort
        their ranks in the same sweep.

        Which process stops: ``kill_task`` signals a Failed row's pid
        only when that process carries the task's ``MLCOMP_TASK_ID``
        marker, i.e. a ``run-task`` process (the worker's default mode),
        which exits 143. Under ``worker N --in-process`` the row holds
        the daemon's own pid, which a prune never signals: there the
        cell stops itself, since the trainer and ``sweep_probe`` poll
        their row at each epoch boundary and return once it is
        terminal."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        if cell.status not in _LIVE:
            return
        if cell.gang_id and self.gang_abort is not None:
            self.gang_abort(cell.id)
        self.provider.fail_with_reason(cell, SWEEP_PRUNED_REASON)
        kill_task(cell.id, session=self.session)
        if self.telemetry is not None:
            self.telemetry.count('supervisor.sweep_pruned')
        if self.logger:
            self.logger.warning(
                f'sweep {sweep.id} ({sweep.name}): pruned cell '
                f'{cell.id} ({cell.name}) at rung {rung} — slot '
                f'recycles this tick', ComponentType.Supervisor,
                None, cell.id)

    # ---------------------------------------------------------------- finish
    def _maybe_finish(self, sweep, cells, entry):
        """Once every cell is terminal, freeze the sweep summary: the
        best FINISHER by ``task.score`` under the sweep's mode.
        Pruned/failed cells carry scores too (their best-so-far), but
        a killed loser's rung-0 spike must never outrank a cell that
        actually trained to completion — finishers strictly dominate;
        non-finishers are the fallback only when nothing succeeded."""
        finished = {int(s) for s in TaskStatus.finished()}
        if any(c.status not in finished for c in cells):
            return
        scored = [c for c in cells if c.score is not None]
        best = None
        if scored:
            sign = 1.0 if (sweep.mode or 'max') == 'min' else -1.0
            best = min(scored, key=lambda c: (
                0 if c.status == int(TaskStatus.Success) else 1,
                sign * float(c.score)))
        # conditional on the prior state: a raced double tick (or a
        # just-promoted standby replaying the finish) loses cleanly
        # instead of overwriting the recorded summary
        cur = self.session.execute(
            "UPDATE sweep SET status='done', best_task=?, "
            "best_score=?, updated=? WHERE id=? AND status='active'",
            (None if best is None else best.id,
             None if best is None else float(best.score),
             now(), sweep.id))
        if cur.rowcount == 0:
            return          # already finished by another incarnation
        sweep.status = 'done'
        if best is not None:
            sweep.best_task = best.id
            sweep.best_score = float(best.score)
        entry['done'] = True
        if best is not None:
            entry['best'] = {'task': best.id,
                             'score': round(best.score, 6)}
        if self.logger:
            self.logger.info(
                f'sweep {sweep.id} ({sweep.name}): done — best '
                + (f'cell {best.id} score {best.score:.6g}'
                   if best is not None else 'cell unknown (no scores)'),
                ComponentType.Supervisor)


__all__ = ['SweepScheduler', 'create_sweep', 'SWEEP_PRUNED_REASON']

"""ASHA rung arithmetic + the sweep score-report contract (port of
``mlcomp_tpu/contrib/search/asha.py``).

Asynchronous successive halving (Li et al., *A System for Massively
Parallel Hyperparameter Tuning*, MLSys 2020; Hyperband, Li et al.,
JMLR 2018) for the grid executor: cells train normally; at budget
rungs ``base * eta^r`` each cell's metric is compared against the
running top-``1/eta`` quantile of every score recorded at that rung so
far, and the losers are killed so their slots recycle into queued
cells. This module is the **pure half** — rung boundaries, quantile
math, spec validation, and the score-report helper — shared by the
supervisor's scheduler (server/sweep.py), the train loop
(train/executor.py), the synthetic sweep-probe executor and the
tests. No torch, no scheduling state: everything here is arithmetic
over plain numbers, so the quantile semantics (ties promote, the
``min_cells_per_rung`` guard, maximize vs minimize) are pinned by unit
tests without a supervisor in sight.

The report contract: a sweep cell emits one ``sweep.score`` metric row
per epoch boundary with ``step`` = budget consumed (epochs or
optimizer steps, per the sweep's ``unit``) and ``value`` = the sweep
metric at that budget. The scheduler judges a cell at rung ``r`` the
moment a report with ``step >= boundary(r)`` exists — asynchronously,
no rung barrier.
"""

import json

#: metric-row name every sweep cell reports rung scores under
SWEEP_SCORE_METRIC = 'sweep.score'

#: hard ceiling on rung count — boundaries grow as eta^r, so real
#: sweeps never get near it; it bounds the scheduler's judge loop
MAX_RUNGS = 64


def normalize_sweep_spec(spec) -> dict:
    """Validate + normalize a ``sweep:`` block at SUBMISSION time, so a
    bad spec is a rejected dag, not a sweep that silently never prunes.

    Returns ``{'metric', 'mode', 'eta', 'base', 'unit',
    'min_cells_per_rung'}``; raises ``ValueError`` on anything else.
    """
    if not isinstance(spec, dict):
        raise ValueError('sweep must be a mapping')
    known = {'metric', 'mode', 'eta', 'rung_epochs', 'rung_steps',
             'min_cells_per_rung'}
    unknown = set(spec) - known
    if unknown:
        raise ValueError(f'unknown sweep option(s): {sorted(unknown)}')
    metric = spec.get('metric')
    if not metric or not isinstance(metric, str):
        raise ValueError('sweep.metric is required (the series name '
                         'cells report, e.g. accuracy or loss)')
    mode = spec.get('mode', 'max')
    if mode not in ('max', 'min'):
        raise ValueError(f'sweep.mode must be max or min, got {mode!r}')
    try:
        eta = float(spec.get('eta', 2))
    except (TypeError, ValueError):
        raise ValueError(f'sweep.eta must be a number, '
                         f'got {spec.get("eta")!r}')
    if eta <= 1:
        raise ValueError(f'sweep.eta must be > 1 (each rung promotes '
                         f'the top 1/eta), got {eta}')
    if ('rung_epochs' in spec) == ('rung_steps' in spec):
        raise ValueError('sweep needs exactly one of rung_epochs or '
                         'rung_steps (the first rung boundary)')
    unit = 'epochs' if 'rung_epochs' in spec else 'steps'
    base = spec.get('rung_epochs', spec.get('rung_steps'))
    if not isinstance(base, (int, float)) or int(base) != base \
            or base < 1:
        raise ValueError(f'sweep.rung_{unit} must be a positive '
                         f'integer, got {base!r}')
    min_cells = spec.get('min_cells_per_rung', 2)
    if not isinstance(min_cells, int) or min_cells < 2:
        raise ValueError('sweep.min_cells_per_rung must be an integer '
                         f'>= 2, got {min_cells!r}')
    return {'metric': metric, 'mode': mode, 'eta': eta,
            'base': int(base), 'unit': unit,
            'min_cells_per_rung': min_cells}


def rung_boundary(base: int, eta: float, rung: int) -> int:
    """Budget (epochs or steps) at which rung ``rung`` is judged:
    ``ceil(base * eta^rung)``, monotone in ``rung`` even for
    fractional eta (a repeated boundary would judge one report at two
    rungs)."""
    budget = base * (float(eta) ** int(rung))
    budget = int(budget) + (budget != int(budget))      # ceil
    # fractional eta < 2 can stall below +1/rung growth; force strict
    # monotonicity against the previous rung
    if rung > 0:
        prev = rung_boundary(base, eta, rung - 1)
        if budget <= prev:
            budget = prev + 1
    return budget


def rung_boundaries(base: int, eta: float, up_to_budget: int):
    """Every rung boundary <= ``up_to_budget``, ascending."""
    out = []
    for rung in range(MAX_RUNGS):
        b = rung_boundary(base, eta, rung)
        if b > up_to_budget:
            break
        out.append(b)
    return out


def promote_cutoff(scores, eta: float, mode: str) -> float:
    """The score a cell must MEET OR BEAT at a rung to be promoted:
    the k-th best of ``scores`` where ``k = max(1, floor(n/eta))`` —
    the running top-``1/eta`` quantile. ``k >= 1`` means the best
    reporter at a rung is never prunable, and ties AT the cutoff
    promote (a cell exactly matching the k-th best score survives:
    pruning on a tie would make the verdict depend on report order).
    """
    if not scores:
        raise ValueError('promote_cutoff needs at least one score')
    k = max(1, int(len(scores) // float(eta)))
    ordered = sorted(scores, reverse=(mode == 'max'))
    return ordered[k - 1]


def judge(score: float, scores, eta: float, mode: str) -> str:
    """'promote' or 'prune' for ``score`` against every score recorded
    at the rung so far (``scores`` must already include ``score``)."""
    cutoff = promote_cutoff(scores, eta, mode)
    if mode == 'max':
        return 'promote' if score >= cutoff else 'prune'
    return 'promote' if score <= cutoff else 'prune'


def score_at_rung(reports, boundary: int):
    """The score a cell holds AT a rung: the first report whose budget
    reached the boundary (``reports``: ascending ``(budget, value)``
    pairs). None while the cell has not trained that far yet."""
    for budget, value in reports:
        if budget >= boundary:
            return value
    return None


def report_sweep_score(session, cell_task_id: int, budget: int,
                       value, component: str = 'train') -> bool:
    """Emit one rung score report — immediate, not buffered: the
    supervisor judges off these rows and a report stuck in a flush
    buffer is a rung judged a tick late. Also publishes on the
    ``tasks`` event channel so a parked supervisor loop wakes and
    judges NOW instead of at its backstop (the report may free a slot
    this very tick). Best-effort: a locked DB must not fail a healthy
    training epoch over observability."""
    from mlcomp_tpu_torch.db.providers import MetricProvider
    from mlcomp_tpu_torch.utils.misc import now
    try:
        MetricProvider(session).add_many([
            (int(cell_task_id), SWEEP_SCORE_METRIC, 'series',
             int(budget), float(value), now(), component,
             json.dumps({'budget': int(budget)}))])
    except Exception:
        return False
    try:
        from mlcomp_tpu_torch.db.events import CH_TASKS
        session.publish_event(CH_TASKS)
    except Exception:
        pass
    return True


def cell_is_terminal(session, task_id: int, attempt: int = None) -> bool:
    """Has the row of a running trainer gone terminal under it: a verdict
    landed on it (a sweep prune ``Failed``/``sweep-pruned``, a preemption
    ``Failed``/``preempted``, a stop), or, where ``attempt`` is given,
    has the retry pass already moved it on to a newer attempt? The one
    in-process stop rule that the trainer (any trainer with a task) and
    ``sweep_probe`` share, polled at each epoch boundary: a verdict
    SIGTERMs a ``run-task`` process, but under ``worker N --in-process``
    no signal reaches the run (the row holds the daemon's pid), so it
    stops itself and frees the card the supervisor has given away. The
    attempt check keeps a preempted run that outlives its retry's
    backoff from training beside its own next attempt. One indexed
    read."""
    from mlcomp_tpu_torch.db.enums import TaskStatus
    from mlcomp_tpu_torch.db.providers import TaskProvider
    row = TaskProvider(session).by_id(task_id)
    if row is None:
        return False
    return row.status >= int(TaskStatus.Failed) or (
        attempt is not None and int(row.attempt or 0) != int(attempt))


__all__ = ['SWEEP_SCORE_METRIC', 'MAX_RUNGS', 'normalize_sweep_spec',
           'rung_boundary', 'rung_boundaries', 'promote_cutoff',
           'judge', 'score_at_rung', 'report_sweep_score',
           'cell_is_terminal']

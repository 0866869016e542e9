"""Multi-tenant scheduling policy — pure functions, no DB (port of
``mlcomp_tpu/server/scheduler.py``: priority classes, aging, fair share,
quota admission and bin packing). The supervisor
(``server/supervisor.py``) feeds it snapshots and applies its verdicts.

- **priority classes** — ``critical > high > normal > preemptible``. A
  row with NULL priority reads its class-based default: sweep cells are
  ``preemptible``, serve replicas ``high``, everything else ``normal``.
- **aging** — waiting escalates effective priority one class per
  :data:`AGING_STEP_S`, so a ``preemptible`` task sorts with
  ``critical`` work after at most ``3 * AGING_STEP_S``.
- **fair share** — among equals, the tenant who consumed the least of
  its quota window goes first.
- **victim selection** — when a higher class cannot fit, evict
  strictly-lower-class work, cheapest first (class, then cores x
  runtime, then youngest), until the blocked ask fits; a multi-host
  gang's plan ranks hosts by reclaimable capacity (``plan_gang``; its
  fan-out, and so its plans' application, is A4).
- **bin packing** — single-node asks best-fit into the tightest
  computer that still fits; gangs and spread work take the most free.
"""

from mlcomp_tpu_torch.db.enums import TaskType

#: scheduling classes, strongest first
PRIORITY_CLASSES = ('critical', 'high', 'normal', 'preemptible')

#: rank: higher = scheduled earlier, preempts lower
PRIORITY_RANK = {'critical': 3, 'high': 2, 'normal': 1, 'preemptible': 0}

#: class-based defaults for rows whose priority column is NULL, keyed
#: by ``task_class_of``
DEFAULT_PRIORITY_BY_CLASS = {
    'sweep': 'preemptible',
    'serve-replica': 'high',
    'service': 'normal',
    'train': 'normal',
}

#: seconds of queue wait that escalate effective priority one class
AGING_STEP_S = 300.0

#: evictions one tick may apply: a burst of high-class asks drains a
#: pool in steps, each step's frees re-placing before the next
MAX_PREEMPTIONS_PER_TICK = 8


def normalize_priority(value, default: str = None):
    """Validated class name or ``default`` (None passes through for
    "no explicit class, use the class-based default")."""
    if value is None or value == '':
        return default
    name = str(value).strip().lower()
    if name not in PRIORITY_RANK:
        raise ValueError(
            f'unknown priority class {value!r} — expected one of '
            f'{", ".join(PRIORITY_CLASSES)}')
    return name


#: the task classes ``task_class_of`` tells apart, in the order of the
#: JAX usage ledger's ``TASK_CLASSES`` (the starvation gauges and the
#: SLO engine's queue-wait objectives go through them)
TASK_CLASSES = ('train', 'sweep', 'serve-replica', 'service')


def task_class_of(task) -> str:
    """Scheduling class of a task row (the JAX usage ledger's
    ``task_class_of``): a sweep cell is 'sweep' even though its
    executor is a trainer, a serve replica 'serve-replica' even though
    its type is Service. Takes Task objects and dict rows."""
    get = task.get if isinstance(task, dict) else \
        lambda k, d=None: getattr(task, k, d)
    info = get('additional_info') or ''
    if 'sweep' in str(info):
        return 'sweep'
    if get('executor') == 'serve_replica':
        return 'serve-replica'
    if get('type') == int(TaskType.Service):
        return 'service'
    return 'train'


def task_priority_of(task) -> str:
    """Effective class of a task row: the explicit column when set,
    else the class-based default."""
    get = task.get if isinstance(task, dict) else \
        lambda k, d=None: getattr(task, k, d)
    explicit = get('priority')
    if explicit in PRIORITY_RANK:
        return explicit
    return DEFAULT_PRIORITY_BY_CLASS.get(task_class_of(task), 'normal')


def effective_rank(priority: str, wait_s: float,
                   aging_step_s: float = AGING_STEP_S) -> int:
    """Class rank plus the aging boost, capped at critical."""
    base = PRIORITY_RANK.get(priority, PRIORITY_RANK['normal'])
    if wait_s and wait_s > 0 and aging_step_s > 0:
        base += int(wait_s // aging_step_s)
    return min(base, PRIORITY_RANK['critical'])


def wait_seconds(task, now_dt) -> float:
    """How long a pending task has waited for placement:
    ``last_activity`` is stamped at creation and at every requeue."""
    anchor = getattr(task, 'last_activity', None)
    if anchor is None:
        return 0.0
    return max(0.0, (now_dt - anchor).total_seconds())


def dispatch_order_key(task, now_dt, usage_share=None,
                       aging_step_s: float = AGING_STEP_S):
    """Sort key of the per-tick dispatch list: strongest effective
    class, then least fair-share consumption (None sorts as 0), then
    the oldest row."""
    waited = wait_seconds(task, now_dt)
    rank = effective_rank(task_priority_of(task), waited, aging_step_s)
    share = 0.0 if usage_share is None else float(usage_share)
    return (-rank, share, int(task.id))


def fair_share_of(tenant_usage: float, limit) -> float:
    """Fraction of the quota window consumed where a ceiling exists,
    else raw usage scaled down, so quota-less tenants still order
    among themselves but never outrank one with a real ceiling."""
    used = float(tenant_usage or 0.0)
    if limit is not None and limit > 0:
        return used / float(limit)
    return used / 1e9


def tenant_share(owner: str, limits: dict, windowed: dict) -> float:
    """An owner's fair-share sort weight from the tick's snapshot."""
    key = ('owner', owner or 'default')
    entry = limits.get((key[0], key[1], 'core_seconds'))
    limit = float(entry[0]) if entry else None
    return fair_share_of(windowed.get(key, 0.0), limit)


def quota_block(priority: str, cores_wanted: int, owner: str,
                project: str, limits: dict, live: dict,
                windowed: dict):
    """Why quota admission refuses this placement, or None to admit.

    ``limits`` maps ``(scope, tenant, resource) -> (limit, window_s)``;
    ``live`` maps ``(scope, tenant) -> cores`` held; ``windowed`` maps
    ``(scope, tenant) -> core_seconds`` in the ledger window. An absent
    limit is unlimited, an explicit 0 locks the tenant out;
    ``critical`` work is exempt."""
    if priority == 'critical':
        return None
    for scope, tenant in (('owner', owner or 'default'),
                          ('project', project or 'default')):
        entry = limits.get((scope, tenant, 'cores'))
        if entry is not None:
            limit = float(entry[0] or 0.0)
            held = float(live.get((scope, tenant), 0))
            if held + cores_wanted > limit:
                return (f'quota: {scope} {tenant} holds '
                        f'{held:g}/{limit:g} cores, '
                        f'+{cores_wanted} would exceed')
        entry = limits.get((scope, tenant, 'core_seconds'))
        if entry is not None:
            limit = float(entry[0] or 0.0)
            used = float(windowed.get((scope, tenant), 0.0))
            if used >= limit:
                return (f'quota: {scope} {tenant} used '
                        f'{used:g}/{limit:g} core-seconds in window')
    return None


# ------------------------------------------------------- victim choice
def victim_cost(victim: dict) -> float:
    """What evicting this victim throws away: held cores x seconds of
    progress since the attempt started."""
    return float(victim.get('cores') or 0) * \
        max(0.0, float(victim.get('run_s') or 0.0))


def victim_order(victims):
    """Cheapest-first eviction order: weakest class, then least sunk
    cost, then youngest row."""
    return sorted(victims, key=lambda v: (
        PRIORITY_RANK.get(v.get('priority'), 1),
        victim_cost(v),
        -int(v.get('task_id') or 0)))


def eligible_victims(victims, blocked_rank: int):
    """Only a strictly lower CLASS rank may be evicted: the aging boost
    earns earlier dispatch, not the power to evict running work."""
    return [v for v in victims
            if PRIORITY_RANK.get(v.get('priority'), 1) < blocked_rank]


def plan_single_node(need: int, free: int, victims,
                     blocked_rank: int):
    """Victims to evict on ONE computer so a single-node ask fits:
    cheapest first until ``free + freed >= need``; [] when it already
    fits, None when evicting everything eligible cannot fit it."""
    if free >= need:
        return []
    chosen, freed = [], 0
    for v in victim_order(eligible_victims(victims, blocked_rank)):
        chosen.append(v)
        freed += int(v.get('cores') or 0)
        if free + freed >= need:
            return chosen
    return None


def plan_gang(need: int, grain: int, hosts, blocked_rank: int):
    """Defragmentation for a blocked multi-host gang: hosts ranked by
    reclaimable capacity (free + evictable), descending, so the gang's
    ``grain``-sized slices land on the FEWEST hosts; per host only what
    its slice needs is evicted.

    ``hosts`` is ``[{name, free, victims}]``; returns ``(plan, used)``,
    plan mapping host name -> victims to evict there (possibly empty),
    or (None, []) when even full eviction cannot fit the gang."""
    if grain <= 0:
        grain = need
    ranked = []
    for h in hosts:
        evictable = eligible_victims(h.get('victims') or [],
                                     blocked_rank)
        reclaimable = int(h.get('free') or 0) + \
            sum(int(v.get('cores') or 0) for v in evictable)
        if min(reclaimable, grain) > 0:
            ranked.append((reclaimable, h, evictable))
    ranked.sort(key=lambda t: (-t[0], t[1].get('name') or ''))
    plan, used, remaining = {}, [], need
    for reclaimable, h, evictable in ranked:
        if remaining <= 0:
            break
        take = min(grain, remaining, reclaimable)
        if take <= 0:
            continue
        shortfall = take - int(h.get('free') or 0)
        evictions = []
        if shortfall > 0:
            freed = 0
            for v in victim_order(evictable):
                evictions.append(v)
                freed += int(v.get('cores') or 0)
                if freed >= shortfall:
                    break
            if freed < shortfall:
                continue    # the host cannot cover its slice
        plan[h.get('name')] = evictions
        used.append((h.get('name'), take))
        remaining -= take
    if remaining > 0:
        return None, []
    return plan, used


def pack_candidates(fits, want: int, multi_host: bool,
                    spread: bool = False):
    """Bin-packing order of ``[(computer, free_core_count)]``:
    single-node asks best-fit into the TIGHTEST computer that satisfies
    the full elastic ask (``want`` = cores_max), hosts too small for it
    last, largest partial grant first; gangs and ``spread`` work (serve
    replicas, anti-affinity) most-free first."""
    if multi_host or spread:
        return sorted(fits, key=lambda cf: -cf[1])
    return sorted(fits, key=lambda cf: (
        cf[1] < want, cf[1] if cf[1] >= want else -cf[1]))


__all__ = [
    'PRIORITY_CLASSES', 'PRIORITY_RANK', 'DEFAULT_PRIORITY_BY_CLASS',
    'TASK_CLASSES',
    'AGING_STEP_S', 'MAX_PREEMPTIONS_PER_TICK', 'normalize_priority',
    'task_class_of', 'task_priority_of', 'effective_rank',
    'dispatch_order_key', 'wait_seconds', 'fair_share_of', 'tenant_share',
    'quota_block', 'victim_cost', 'victim_order', 'eligible_victims',
    'plan_single_node', 'plan_gang', 'pack_candidates',
]

"""Automatic failure recovery (port of ``mlcomp_tpu/recovery.py``):
the failure taxonomy, the retry policy and the requeue plumbing. Every
task failure is classified into ``task.failure_reason``; the
supervisor's recovery pass retries the transient ones from the last
checkpoint with exponential backoff, and raises a ``retry-exhausted``
alert when the budget is spent.

==============  =========  ==================================================
reason          class      set by
==============  =========  ==================================================
db-error        transient  sqlite errors
io-error        transient  ``ConnectionError``/``TimeoutError``/``OSError``
preempted       transient  SIGTERM/SIGKILL of the task subprocess
stall-killed    transient  the watchdog's task-stall kill (JAX supervisor)
worker-lost     transient  dead-pid reaper / worker subprocess vanished
lease-expired   transient  queue lease reclaim gave up on a dead host
gang-peer-lost  transient  a peer rank of a gang never showed up
gang-aborted    transient  the gang-abort sweep killed a surviving rank
replica-unhealthy transient  the fleet reconciler gave up on a replica
sweep-pruned    permanent  the ASHA sweep scheduler's rung verdict
                           (server/sweep.py): the cell lost its rung and
                           was killed to free its slot. Never retried;
                           the ``sweep_decision`` row is the audit trail
oom             permanent  out of device memory (CUDA's ``OutOfMemoryError``
                           says "out of memory") or host ``MemoryError``
executor-error  permanent  any other exception, and the deterministic OS
                           errors (missing file, permission, ...)
==============  =========  ==================================================

``gang-peer-lost`` and ``gang-aborted`` are COLLATERAL reasons: a gang's
verdict (``aggregate_child_reasons``) prefers a sibling's root cause
over them. Retries resume rather than restart: the requeue attaches the
``resume`` info of restart-with-resume, and the computer that just
failed the task is excluded from the next placement (softly: a
one-computer cluster still places).
"""

import hashlib
import sqlite3

from mlcomp_tpu_torch.db.enums import TaskStatus, TaskType
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load

#: reasons the supervisor retries automatically
TRANSIENT_REASONS = frozenset({
    'db-error', 'io-error', 'preempted', 'stall-killed', 'worker-lost',
    'lease-expired', 'gang-peer-lost', 'gang-aborted',
    'replica-unhealthy',
})

#: transient reasons that describe gang COLLATERAL, not a root cause
GANG_COLLATERAL_REASONS = frozenset({'gang-peer-lost', 'gang-aborted'})

#: deterministic OSError subclasses that must NOT classify as transient
_DETERMINISTIC_OS_ERRORS = (FileNotFoundError, PermissionError,
                            IsADirectoryError, NotADirectoryError)

#: error-text markers of device memory exhaustion (XLA's status name,
#: the allocators' wordings; CUDA's ``OutOfMemoryError`` says "out of
#: memory")
_OOM_MARKERS = ('resource_exhausted', 'resource exhausted',
                'out of memory', 'out-of-memory',
                'memory allocation failure')


def classify_exception(exc) -> str:
    """Failure reason for an exception raised by the task pipeline.
    Walks the cause/context chain so a transient root wrapped in a
    framework exception still classifies transient. (The JAX package's
    gang carve-out, ``gang=True``, waits for distributed tasks: A4.)"""
    seen = set()
    cur = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, MemoryError):
            return 'oom'        # host-side exhaustion: same verdict
        if isinstance(cur, RuntimeError):
            text = f'{type(cur).__name__}: {cur}'.lower()
            if any(marker in text for marker in _OOM_MARKERS):
                return 'oom'
        if isinstance(cur, sqlite3.Error):
            return 'db-error'
        if isinstance(cur, _DETERMINISTIC_OS_ERRORS):
            return 'executor-error'
        if isinstance(cur, (ConnectionError, TimeoutError, OSError)):
            return 'io-error'
        cur = cur.__cause__ or cur.__context__
    return 'executor-error'


def is_transient(reason) -> bool:
    return reason in TRANSIENT_REASONS


def aggregate_child_reasons(reasons) -> str:
    """The failure reason a distributed parent (gang) inherits from its
    Failed service children, or None (never retried): any permanent or
    missing child reason pins the verdict; all-transient children
    retry, preferring a root cause over gang collateral."""
    reasons = list(reasons)
    if not reasons:
        return None
    for reason in reasons:
        if not reason or not is_transient(reason):
            return reason or None
    for reason in reasons:
        if reason not in GANG_COLLATERAL_REASONS:
            return reason
    return reasons[0]


def classify_returncode(returncode) -> str:
    """Failure reason for a task subprocess that died with this exit
    status, or None when the code says nothing (the process likely
    classified its own exception). Covers the ``Popen`` negative-signal
    convention and the 128+N shell codes."""
    if returncode in (-15, 143):        # SIGTERM: preemption notice
        return 'preempted'
    if returncode in (-9, 137):         # SIGKILL: preempted / OOM-killed
        return 'preempted'
    return None


class RecoveryConfig:
    """Retry-policy knobs; construct with keyword overrides
    (``RecoveryConfig(lease_seconds=5, backoff_base_s=0.1)``)."""

    #: seconds a claimed queue message stays leased to its worker: it
    #: guards the dispatch (claim to InProgress), not the run
    lease_seconds = 60.0
    #: default retry budget for tasks without their own max_retries
    max_retries = 3.0
    #: exponential backoff: base * factor**attempt, capped
    backoff_base_s = 30.0
    backoff_factor = 2.0
    backoff_cap_s = 900.0
    #: jitter fraction on top of the backoff, deterministic per
    #: (task, attempt)
    jitter_frac = 0.2
    #: seconds a rank of a multi-host gang waits for its peers (stamped
    #: into distr_info at fan-out, A4)
    join_timeout_s = 300.0

    def __init__(self, **overrides):
        for key, value in overrides.items():
            if not hasattr(type(self), key):
                raise TypeError(f'unknown recovery option {key!r}')
            setattr(self, key, float(value))


def retry_delay_s(attempt: int, config: RecoveryConfig = None,
                  task_id: int = 0) -> float:
    """Backoff before retry number ``attempt + 1``: exponential with a
    cap, plus jitter from the hash of (task, attempt), so a burst of
    simultaneous failures de-syncs without ``random``."""
    config = config or RecoveryConfig()
    base = float(config.backoff_base_s) * \
        (float(config.backoff_factor) ** int(attempt))
    base = min(base, float(config.backoff_cap_s))
    digest = hashlib.sha256(
        f'{int(task_id)}:{int(attempt)}'.encode()).hexdigest()[:8]
    jitter = (int(digest, 16) / 0xffffffff) * \
        float(config.jitter_frac) * base
    return base + jitter


# ------------------------------------------------------------- requeue
def find_resume_info(provider, task) -> dict:
    """The ``resume`` blob a requeued task carries: where its checkpoint
    master ran. For a distributed parent the rank-0 service child owns
    the checkpoint folder; ``LookupError`` when children exist but no
    rank-0 child is found."""
    children = sorted(provider.children(task.id),
                      key=lambda c: c.id, reverse=True)
    if children:
        for c in children:
            info = yaml_load(c.additional_info) \
                if c.additional_info else {}
            distr = (info or {}).get('distr_info')
            if not distr:
                continue
            if distr.get('process_index', distr.get('rank')) == 0:
                return {'master_computer': c.computer_assigned,
                        'master_task_id': c.id,
                        'load_last': True}
        raise LookupError('master task not found')
    return {'master_computer': task.computer_assigned,
            'master_task_id': task.id,
            'load_last': True}


def detach_service_children(session, task_id: int) -> int:
    """Detach the FINISHED service children of a task about to requeue
    (``parent=NULL``; rows and telemetry stay), so parent aggregation
    does not fail the fresh attempt on the last attempt's children."""
    finished = ','.join(str(int(s)) for s in TaskStatus.finished())
    cur = session.execute(
        f'UPDATE task SET parent=NULL WHERE parent=? AND type=? '
        f'AND status IN ({finished})',
        (int(task_id), int(TaskType.Service)))
    return cur.rowcount


def reset_for_requeue(provider, task, resume: dict = None,
                      exclude_computer=None,
                      reset_attempts: bool = False):
    """Reset a finished task to NotRan for re-dispatch, the ``resume``
    info attached so training continues from the last checkpoint and
    ``exclude_computer`` (a name or names) kept off the next
    placement."""
    info = yaml_load(task.additional_info) \
        if task.additional_info else {}
    info = dict(info or {})
    if resume is not None:
        info['resume'] = resume
    else:
        # a stale resume blob from an earlier attempt would restore an
        # outdated checkpoint
        info.pop('resume', None)
    if exclude_computer:
        if isinstance(exclude_computer, str):
            exclude_computer = [exclude_computer]
        info['retry_exclude'] = sorted(set(exclude_computer))
    else:
        info.pop('retry_exclude', None)
    detach_service_children(provider.session, task.id)
    task.additional_info = yaml_dump(info)
    # requeue is reached only from the supervisor's retry pass (one
    # tick thread, the task already terminal) and ``/api/dag/start``
    # (server/api.py), which rejects unfinished tasks before calling
    # in: no live writer races a terminal row's reset
    # preflight: disable=db-naked-transition — see above
    task.status = int(TaskStatus.NotRan)
    task.pid = None
    task.started = None
    task.finished = None
    task.computer_assigned = None
    task.queue_id = None
    task.worker_index = None
    task.docker_assigned = None
    task.next_retry_at = None
    if reset_attempts:
        task.attempt = 0
        task.failure_reason = None
    provider.update(task)


__all__ = ['TRANSIENT_REASONS', 'GANG_COLLATERAL_REASONS', 'is_transient',
           'aggregate_child_reasons', 'classify_exception',
           'classify_returncode', 'RecoveryConfig', 'retry_delay_s',
           'find_resume_info', 'detach_service_children',
           'reset_for_requeue']

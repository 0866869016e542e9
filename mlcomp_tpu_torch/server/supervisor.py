"""Supervisor — the scheduling tick (port of
``mlcomp_tpu/server/supervisor.py``).

Each tick (``SupervisorBuilder.build``):

1. ``create_base``          — live queues from docker heartbeats (< 15 s)
2. ``process_parent_tasks`` — child→parent status aggregation; a failed
   child gang-aborts its siblings
3. ``process_recovery``     — lease reclaim, strand sweep, retry of
   transient failures with backoff
4. ``load_tasks``           — NotRan tasks in dispatch order (class,
   aging, fair share, age) + their dependency status sets
5. ``load_computers``       — free-resource model per computer: card
   slot array + cpu + memory, minus Queued/InProgress assignments
6. ``process_tasks``        — preflight and dependency gating
   (failed dependency → Skipped), then placement and dispatch onto the
   DB queue ``{computer}_{docker}``
7. ``write_auxiliary``      — the decision trace into ``auxiliary``

With a :class:`~mlcomp_tpu_torch.server.ha.LeaderLease` (HA, the
default of ``register_supervisor``) the builder issues every write on a
:class:`~mlcomp_tpu_torch.db.fencing.FencedSession`: each mutation of a
control-state table carries the leader's epoch, so a paused ex-leader's
writes are rejected in the DB. The loop contends for the lease, runs
``reconcile_dispatches`` at promotion and releases the lease when it
stops.

What the JAX tick does beyond this is not ported and refuses rather
than being skipped silently (ROADMAP.md, A0): a DB holding fleet or
sweep rows (the fleet reconciler, the ASHA sweep scheduler), one
holding quota rows, a tick whose preemption pass would evict (quotas
and preemption), and the multi-host fan-out (A4), each raise
``NotImplementedError``. The tick telemetry and the watchdog, SLO and
usage folds write observability and ledger rows no decision here reads,
and are left out, but for the count of fenced-off writes; the tick
flushes its dispatch spans.
"""

import datetime
import json
import threading
import traceback

from mlcomp_tpu_torch import MASTER_PORT_RANGE
from mlcomp_tpu_torch.db.core import Session, parse_datetime
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus, TaskType
from mlcomp_tpu_torch.db.events import (
    CH_QUEUE_DONE, CH_SUPERVISOR_LEASE, CH_TASKS,
)
from mlcomp_tpu_torch.db.fencing import (
    FencedSession, FenceLostError, fence_rejections,
)
from mlcomp_tpu_torch.db.models import QueueMessage, Task
from mlcomp_tpu_torch.db.providers import (
    AlertProvider, AuxiliaryProvider, ComputerProvider, DagPreflightProvider,
    DagProvider, DockerProvider, MetricProvider, QueueProvider, TaskProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.utils.misc import now

#: an InProgress task's silence after which its lease may be reclaimed
#: (the JAX watchdog's default ``stall_deadline_s``): sized for the
#: longest legitimate gap without a metric flush (first compile, a
#: dataset download)
STALL_DEADLINE_S = 1800.0

#: tables whose rows only unported parts of the JAX tick act on, each
#: with the ROADMAP.md item that brings it
UNPORTED_TABLES = (
    ('serve_fleet', 'fleets (server/fleet.py) with gateway.py'),
    ('sweep', 'ASHA sweeps (server/sweep.py)'),
)


def _refusal(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not ported yet (ROADMAP.md, A0: {item})')


def _info(task: Task) -> dict:
    return (yaml_load(task.additional_info)
            if task.additional_info else {}) or {}


class SupervisorBuilder:
    def __init__(self, session: Session = None, logger=None,
                 queue_liveness_window: float = 15.0,
                 recovery_config: RecoveryConfig = None, lease=None):
        session = session or Session.create_session(key='supervisor')
        if isinstance(session, FencedSession):    # heal-path re-init
            session = session._session
        # the raw session serves the heal path and the lease protocol;
        # with a lease every write of this builder rides the fence
        self.raw_session = session
        self.lease = lease
        self.session = FencedSession(session, lease) \
            if lease is not None else session
        self.logger = logger
        self.queue_liveness_window = queue_liveness_window
        self.recovery_config = recovery_config or RecoveryConfig()
        self.provider = TaskProvider(self.session)
        self.computer_provider = ComputerProvider(self.session)
        self.docker_provider = DockerProvider(self.session)
        self.queue_provider = QueueProvider(self.session)
        self.dag_provider = DagProvider(self.session)
        self.auxiliary_provider = AuxiliaryProvider(self.session)

        self.queues = []
        self.alive_computers = set()
        self.tasks = []
        self.dep_status = {}
        self.computers = []
        self.aux = {}
        # per-tick scheduling snapshot (quota limits, live cores,
        # windowed core-seconds); None = not read this tick
        self._sched_snapshot = None
        # tasks this tick's placement could not fit for capacity: the
        # JAX preemption pass's worklist
        self._capacity_blocked = []
        # dag id -> [error findings] ([] = passed), filled the first
        # time a NotRan task of that dag reaches placement
        self._preflight_cache = {}
        # (queue, payload) -> pending msg id, loaded once per tick so
        # dispatch's restart-idempotency check costs no round trip per
        # task; None outside a tick (dispatch falls back to find_active)
        self._pending_execute = None
        # fence rejections already counted into supervisor.fenced_writes
        self._fence_seen = fence_rejections()

    def _log_error(self, msg: str, task: int = None):
        if self.logger:
            self.logger.error(msg, ComponentType.Supervisor, None, task)

    def _log_warning(self, msg: str, task: int = None):
        if self.logger:
            self.logger.warning(msg, ComponentType.Supervisor, None, task)

    # ----------------------------------------------------------- base state
    def refuse_unported(self):
        """Raise where the DB holds rows only an unported part of the
        JAX tick acts on: ticking on would leave them unserved."""
        for table, item in UNPORTED_TABLES:
            if self.session.query_one(f'SELECT 1 FROM {table} LIMIT 1'):
                raise _refusal(f'a DB with {table} rows', item)

    def create_base(self):
        """Live queues = (computer, docker) pairs with a fresh
        heartbeat."""
        self.aux = {'time': str(now()), 'duration': None}
        alive = self.docker_provider.alive(self.queue_liveness_window)
        self.queues = [f'{d.computer}_{d.name}' for d in alive]
        # host liveness for the lease reclaim (computer names may hold
        # underscores, so not parsed from queue names)
        self.alive_computers = {d.computer for d in alive}
        self.aux['queues'] = list(self.queues)
        try:
            self._pending_execute = self.queue_provider.pending_index()
        except Exception:
            self._pending_execute = None
        self._sched_snapshot = None
        self._capacity_blocked = []

    # -------------------------------------------------------- parent tasks
    def process_parent_tasks(self):
        """Aggregate child statuses into distributed parents; a failed
        child gang-aborts its siblings."""
        processed = []
        for parent_task, _started, _finished, statuses in \
                self.provider.parent_tasks_stats():
            total = sum(statuses.values())
            bad = statuses.get(int(TaskStatus.Failed), 0) + \
                statuses.get(int(TaskStatus.Stopped), 0) + \
                statuses.get(int(TaskStatus.Skipped), 0)
            done = statuses.get(int(TaskStatus.Success), 0)
            new_status = None
            if bad:
                new_status = TaskStatus.Failed
            elif total and done == total:
                new_status = TaskStatus.Success
            elif statuses.get(int(TaskStatus.InProgress), 0):
                new_status = TaskStatus.InProgress
            if new_status is not None and \
                    parent_task.status != int(new_status):
                if new_status == TaskStatus.Failed:
                    self._fail_gang_parent(parent_task)
                else:
                    self.provider.change_status(parent_task, new_status)
                processed.append(
                    {'parent': parent_task.id, 'status': new_status.name})
        self.aux['parent_tasks'] = processed

    def _fail_gang_parent(self, parent_task: Task):
        """Abort the surviving ranks, aggregate the ranks' failure
        taxonomy into the parent's verdict, mark the parent Failed: the
        PARENT is the unit of retry."""
        from mlcomp_tpu_torch.recovery import aggregate_child_reasons
        self.gang_abort(parent_task.id)
        parent_task.failure_reason = aggregate_child_reasons(
            c.failure_reason for c in self.provider.children(
                parent_task.id, statuses=[TaskStatus.Failed]))
        self.provider.update(parent_task, ['failure_reason'])
        if parent_task.status != int(TaskStatus.Failed):
            self.provider.change_status(parent_task, TaskStatus.Failed)

    def gang_abort(self, parent_id: int):
        """Kill and revoke every surviving child of a failing parent in
        one sweep: a gang rank (``distr_info`` or ``gang_id``) is first
        Failed ``gang-aborted`` (kill_task never downgrades a Failed
        status), then killed; other service children are stopped."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        aborted = []
        for child in self.provider.children(
                parent_id,
                statuses=[TaskStatus.NotRan, TaskStatus.Queued,
                          TaskStatus.InProgress]):
            try:
                is_rank = bool(_info(child).get('distr_info')) \
                    or bool(child.gang_id)
                if is_rank:
                    self.provider.fail_with_reason(child, 'gang-aborted')
                kill_task(child.id, session=self.session)
                if is_rank:
                    aborted.append(child.id)
            except FenceLostError:
                raise       # zombie leader: stop the tick, demote
            except Exception:
                self._log_error(f'gang abort of child {child.id} failed:\n'
                                f'{traceback.format_exc()}')
        if aborted:
            self.aux.setdefault('gang_aborted', {})[parent_id] = aborted
            self._log_warning(f'gang of task {parent_id}: aborted '
                              f'surviving rank task(s) {aborted}',
                              parent_id)

    # -------------------------------------------------------------- loading
    def load_tasks(self):
        """NotRan tasks + dependency status sets, in dispatch order
        (server/scheduler.py): strongest effective class first, then
        least fair-share consumption, then row age."""
        from mlcomp_tpu_torch.server.scheduler import (
            dispatch_order_key, tenant_share,
        )
        self.tasks = [
            t for t in self.provider.by_status(TaskStatus.NotRan)
            if not t.debug]
        limits, _live, windowed = self._scheduling_snapshot()
        now_dt = now()
        self.tasks.sort(key=lambda t: dispatch_order_key(
            t, now_dt,
            usage_share=tenant_share(t.owner, limits, windowed)))
        self.dep_status = self.provider.dependency_status(
            [t.id for t in self.tasks])
        self.aux['tasks_to_process'] = [t.id for t in self.tasks]

    def _scheduling_snapshot(self):
        """(limits, live, windowed), read once per tick. Quota rows
        raise (their admission reads the usage ledger, whose fold is not
        ported), so every tenant is unlimited and every fair-share
        weight 0, as the JAX tick reads a DB without quota rows."""
        if self._sched_snapshot is None:
            if self.session.query_one('SELECT 1 FROM quota LIMIT 1'):
                raise _refusal('a DB with quota rows',
                               'quotas and preemption')
            self._sched_snapshot = ({}, {}, {})
        return self._sched_snapshot

    def load_computers(self):
        """Free-resource model per computer: card slot array + cpu +
        memory, minus everything Queued/InProgress there; the
        coordinator ports in use."""
        computers = []
        for c in self.computer_provider.all():
            computers.append({
                'name': c.name,
                'cpu': c.cpu,
                'memory': c.memory,
                'cores': [False] * (c.cores or 0),  # False = free
                'ports': set(),
                'can_process_tasks': bool(c.can_process_tasks),
                'ip': c.ip,
            })
        index = {c['name']: c for c in computers}
        for task in self.provider.by_status(
                TaskStatus.Queued, TaskStatus.InProgress):
            comp = index.get(task.computer_assigned)
            if comp is None:
                continue
            comp['cpu'] -= task.cpu or 0
            comp['memory'] -= task.memory or 0
            if task.cores_assigned:
                try:
                    for core in json.loads(task.cores_assigned):
                        if 0 <= core < len(comp['cores']):
                            comp['cores'][core] = True
                except (TypeError, ValueError):
                    pass
            port = (_info(task).get('distr_info') or {}).get('port')
            if port:
                comp['ports'].add(int(port))
        self.computers = computers
        self.aux['computers'] = [
            {**c, 'cores': ''.join('x' if b else '.' for b in c['cores']),
             'ports': sorted(c['ports'])}
            for c in computers]

    # ------------------------------------------------------------ placement
    def _free_cores(self, comp):
        return [i for i, used in enumerate(comp['cores']) if not used]

    def _valid_computer(self, task: Task, comp) -> str:
        """'' if the computer can host the task, else the reason."""
        if not comp['can_process_tasks']:
            return 'cannot process tasks'
        if task.computer and task.computer != comp['name']:
            return f'pinned to {task.computer}'
        if (task.cpu or 0) > comp['cpu']:
            return f'cpu: need {task.cpu} have {comp["cpu"]}'
        if (task.memory or 0) > comp['memory']:
            return f'memory: need {task.memory} have {comp["memory"]}'
        queue = f'{comp["name"]}_{task.docker_assigned or "default"}'
        if queue not in self.queues:
            return f'queue {queue} not alive'
        free = len(self._free_cores(comp))
        if (task.cores or 0) > 0 and free < 1:
            return f'no free cores (need up to {task.cores_max})'
        return ''

    def _candidate_computers(self, task: Task):
        """(computers that fit, in packing order; {name: reason} of the
        rest). The computer that just failed a retried task is skipped
        softly: only while another candidate remains."""
        from mlcomp_tpu_torch.server.scheduler import pack_candidates
        reasons = {}
        fits = []
        for comp in self.computers:
            reason = self._valid_computer(task, comp)
            if reason:
                reasons[comp['name']] = reason
            else:
                fits.append(comp)
        info = _info(task)
        exclude = set(info.get('retry_exclude') or [])
        if exclude:
            kept = [c for c in fits if c['name'] not in exclude]
            if kept:
                for c in fits:
                    if c['name'] in exclude:
                        reasons[c['name']] = 'excluded after failure'
                fits = kept
        multi_host = (task.cores_max or 0) > 1 and not task.single_node
        want = task.cores_max or task.cores or 0
        fits = [c for c, _free in pack_candidates(
            [(c, len(self._free_cores(c))) for c in fits],
            int(want), multi_host, spread=bool(info.get('serve')))]
        return fits, reasons

    def find_port(self, comp) -> int:
        """Coordinator port from the per-computer range; released when
        its gang leaves Queued/InProgress (``comp['ports']`` is rebuilt
        every tick)."""
        lo, hi = MASTER_PORT_RANGE
        for port in range(lo, hi + 1):
            if port not in comp['ports']:
                comp['ports'].add(port)
                return port
        raise RuntimeError(f'no free port on {comp["name"]}')

    # ------------------------------------------------------------- dispatch
    def task_trace_id(self, task: Task):
        """The trace id minted for this task's DAG submission
        (create_dags/standard.py); rows without one stay traceless."""
        return _info(task).get('trace_id')

    def dispatch(self, task: Task, comp, cores):
        """Assign cores and enqueue to ``{computer}_{docker}``, inside a
        ``supervisor.dispatch`` span; the trace id rides the payload so
        the claiming worker joins the submission's trace."""
        from mlcomp_tpu_torch.telemetry import span
        task.computer_assigned = comp['name']
        task.cores_assigned = json.dumps(cores)
        docker = task.docker_assigned or 'default'
        queue = f'{comp["name"]}_{docker}'
        trace_id = self.task_trace_id(task)
        payload = {'action': 'execute', 'task_id': task.id}
        if trace_id:
            payload['trace_id'] = trace_id
        with span('supervisor.dispatch', task=task.id,
                  trace_id=trace_id, role='supervisor',
                  tags={'queue': queue, 'cores': len(cores)}):
            # crash-consistent order: placement stamped on the NotRan
            # row, then the message, then queue_id + Queued pair them.
            # Idempotent against a supervisor death between the two: a
            # pending message with this payload is reused, and the next
            # leader's ``reconcile_dispatches`` re-pairs (or rolls back)
            # the one torn shape, an assigned NotRan row beside a
            # pending message
            self.provider.update(
                task, ['computer_assigned', 'cores_assigned'])
            if self._pending_execute is not None:
                # a hit is re-validated: a revoke may have landed since
                # the tick's snapshot
                msg_id = self._pending_execute.get(
                    (queue, json.dumps(payload)))
                if msg_id is not None:
                    msg_id = self.queue_provider.find_active(
                        queue, payload)
            else:
                msg_id = self.queue_provider.find_active(queue, payload)
            if msg_id is None:
                msg_id = self.queue_provider.enqueue(queue, payload)
            task.queue_id = msg_id
            self.provider.update(task, ['queue_id'])
            self.provider.change_status(task, TaskStatus.Queued)
        for core in cores:
            comp['cores'][core] = True
        comp['cpu'] -= task.cpu or 0
        comp['memory'] -= task.memory or 0
        return queue

    def reconcile_dispatches(self) -> dict:
        """The promotion sweep: repair the half-dispatches a dead leader
        left, exactly once, before the first tick of a new epoch. Two
        torn shapes exist (dispatch's order pins them):

        - a PENDING execute message whose task never got its
          ``queue_id``/Queued write: if the task is still NotRan with
          its placement stamped, the pair is completed (**adopted**); a
          message whose task moved on in any other way is **revoked**,
          so it never executes twice;
        - a QUEUED task whose message is missing or revoked: reset to
          NotRan, so placement re-dispatches it this tick.

        Claimed, done and failed messages are left to the lease reclaim
        and the strand sweep. Runs on the fenced session, so the repair
        too is epoch-guarded."""
        out = {'adopted': [], 'revoked': [], 'requeued': []}
        qp = self.queue_provider
        rows = self.session.query(
            "SELECT * FROM queue_message WHERE status='pending'")
        for msg in [QueueMessage.from_row(r) for r in rows]:
            try:
                payload = json.loads(msg.payload)
            except (TypeError, ValueError):
                continue
            if payload.get('action') != 'execute':
                continue
            task = self._message_task(msg)
            if task is None:
                qp.revoke(msg.id)
                out['revoked'].append(msg.id)
                continue
            if task.status == int(TaskStatus.Queued) \
                    and task.queue_id == msg.id:
                continue        # consistent pair
            if task.status == int(TaskStatus.NotRan) \
                    and task.computer_assigned \
                    and task.queue_id in (None, msg.id):
                # the torn pair: message out, pairing write lost
                task.queue_id = msg.id
                self.provider.update(task, ['queue_id'])
                self.provider.change_status(task, TaskStatus.Queued)
                out['adopted'].append({'task': task.id, 'msg': msg.id})
            elif qp.revoke(msg.id):
                # the task moved on without this message: a duplicate
                # dispatch must not survive the failover
                out['revoked'].append(msg.id)
        # Queued tasks whose message is no longer deliverable, their
        # messages read in one query
        queued = [t for t in self.provider.by_status(TaskStatus.Queued)
                  if t.queue_id is not None and t.parent is None]
        msg_status = {}
        if queued:
            ids = sorted({t.queue_id for t in queued})
            marks = ','.join('?' * len(ids))
            msg_status = {r['id']: r['status'] for r in self.session.query(
                f'SELECT id, status FROM queue_message '
                f'WHERE id IN ({marks})', tuple(ids))}
        for task in queued:
            if msg_status.get(task.queue_id) in (None, 'revoked'):
                task.queue_id = None
                task.pid = None
                self.provider.update(task, ['queue_id', 'pid'])
                self.provider.change_status(task, TaskStatus.NotRan)
                out['requeued'].append(task.id)
        if any(out.values()):
            self.aux.setdefault('dispatch_reconciled', out)
            self._log_warning(
                f'promotion sweep repaired half-dispatches: '
                f'{sum(len(v) for v in out.values())} '
                f'(adopted={out["adopted"]}, revoked={out["revoked"]}, '
                f'requeued={out["requeued"]})')
        return out

    def process_task(self, task: Task):
        """Placement + dispatch of one runnable task onto one computer.
        A task that asks for distributed execution over several
        computers raises: the multi-host fan-out is A4."""
        fits, reasons = self._candidate_computers(task)
        if not fits:
            self.aux.setdefault('not_placed', {})[task.id] = reasons
            if any(str(r).startswith('no free cores')
                   for r in reasons.values()):
                self._capacity_blocked.append(task)
            return
        info = _info(task)
        distr = bool(info.get('distr', task.cores_max > 1))
        mesh_spec = info.get('mesh') \
            if isinstance(info.get('mesh'), dict) else None
        from mlcomp_tpu_torch.parallel.meshspec import check_mesh_spec
        mesh_exact = None
        mesh_fixed = 1   # fixed-axes product a wildcard grant must divide
        if mesh_spec:
            try:
                fixed, wild = check_mesh_spec(mesh_spec)
                mesh_exact = fixed if wild is None else None
                mesh_fixed = max(fixed, 1)
            except ValueError as e:   # rows older than build-time checks
                self.aux.setdefault('mesh_rejected', {})[task.id] = str(e)
                return
        if not (task.cores_max <= 1 or task.single_node or not distr):
            raise NotImplementedError(
                f'task {task.id} asks for distributed execution over '
                f'several computers (cores_max {task.cores_max}, '
                f'single_node false): the multi-host fan-out is not '
                f'ported yet (ROADMAP.md, A4)')
        comp = fits[0]
        free = self._free_cores(comp)
        want = mesh_exact or task.cores_max or task.cores or 0
        cores = free[:want] if want else []
        if mesh_spec:
            cores = cores[:len(cores) // mesh_fixed * mesh_fixed]
        need = mesh_exact or task.cores or 0
        if need > len(cores):
            self.aux.setdefault('not_placed', {})[task.id] = {
                comp['name']: f'need {need} cores'
                              + (f' (mesh {mesh_spec})' if mesh_spec
                                 else '')
                              + f', free {len(free)}'}
            self._capacity_blocked.append(task)
            return
        queue = self.dispatch(task, comp, cores)
        self.aux.setdefault('dispatched', []).append(
            {'task': task.id, 'queue': queue, 'cores': cores})

    # ------------------------------------------------------------- recovery
    def process_recovery(self):
        """Lease reclaim, strand sweep and retry of transient failures
        (mlcomp_tpu_torch/recovery.py). A crash here never takes the
        tick down."""
        try:
            self._reclaim_leases()
            self._retry_failed()
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'recovery pass failed:\n'
                            f'{traceback.format_exc()}')

    def _message_task(self, msg):
        try:
            task_id = json.loads(msg.payload).get('task_id')
        except (ValueError, TypeError):
            return None
        return self.provider.by_id(task_id) if task_id else None

    def _reclaim_leases(self):
        """Claimed messages whose lease expired on a host without a
        heartbeat go back to pending exactly once; a re-delivered one
        nobody claimed for another lease window fails, its task
        ``lease-expired`` for the retry pass."""
        lease = float(self.recovery_config.lease_seconds)
        qp = self.queue_provider
        for msg in qp.claimed_expired(lease):
            host = (msg.claimed_by or '').rsplit(':', 1)[0]
            if host and host in self.alive_computers:
                continue        # the host's own reaper owns local deaths
            task = self._message_task(msg)
            if task is not None and task.queue_id == msg.id and \
                    task.status == int(TaskStatus.InProgress):
                # a claim spans the whole run: an InProgress task is
                # reclaimed only once its own silence passes the stall
                # deadline
                last = parse_datetime(task.last_activity)
                horizon = max(lease, STALL_DEADLINE_S)
                if last is not None and \
                        (now() - last).total_seconds() < horizon:
                    continue
            if not qp.reclaim(msg.id):
                # already re-delivered once and its claimant died again:
                # no third delivery
                if qp.expire_claim(msg.id):
                    if task is not None and task.queue_id == msg.id \
                            and task.status in (
                                int(TaskStatus.Queued),
                                int(TaskStatus.InProgress)):
                        self.provider.fail_with_reason(
                            task, 'lease-expired')
                    self.aux.setdefault('lease_stranded', []).append(
                        {'msg': msg.id, 'queue': msg.queue,
                         'second_death': True})
                continue
            if task is not None and task.queue_id == msg.id and \
                    task.status in (int(TaskStatus.Queued),
                                    int(TaskStatus.InProgress)):
                # the re-delivered execute must pass the worker's
                # status guard
                task.pid = None
                self.provider.update(task, ['pid'])
                if task.status == int(TaskStatus.InProgress):
                    self.provider.change_status(task, TaskStatus.Queued)
            self.aux.setdefault('lease_reclaimed', []).append(
                {'msg': msg.id, 'queue': msg.queue,
                 'worker': msg.claimed_by})
            self._log_warning(
                f'queue message {msg.id} ({msg.queue}): lease expired '
                f'on dead worker {msg.claimed_by!r} — re-delivered')
        for msg in qp.stranded_redelivered(lease):
            if msg.queue in self.queues:
                continue        # queue is alive: a claim will come
            if not qp.fail_stranded(msg.id):
                continue        # claimed meanwhile: the claim wins
            task = self._message_task(msg)
            self.aux.setdefault('lease_stranded', []).append(
                {'msg': msg.id, 'queue': msg.queue})
            if task is not None and task.queue_id == msg.id and \
                    task.status in (int(TaskStatus.Queued),
                                    int(TaskStatus.InProgress)):
                self.provider.fail_with_reason(task, 'lease-expired')
                self._log_error(
                    f'task {task.id} ({task.name}): re-delivered dispatch '
                    f'stranded on dead queue {msg.queue} — failed for '
                    f'retry elsewhere', task.id)

    def _retry_failed(self):
        """Requeue transiently Failed tasks after their backoff; an
        exhausted budget raises one ``retry-exhausted`` alert. Service
        rows are never units of retry: their parent is."""
        from mlcomp_tpu_torch.recovery import (
            TRANSIENT_REASONS, retry_delay_s,
        )
        cfg = self.recovery_config
        now_dt = now()
        reasons = sorted(TRANSIENT_REASONS)
        marks = ','.join('?' * len(reasons))
        rows = self.session.query(
            f'SELECT * FROM task WHERE status=? AND parent IS NULL '
            f'AND type != ? AND failure_reason IN ({marks})',
            (int(TaskStatus.Failed), int(TaskType.Service), *reasons))
        for task in [Task.from_row(r) for r in rows]:
            reason = task.failure_reason
            attempt = task.attempt or 0
            budget = task.max_retries if task.max_retries is not None \
                else int(cfg.max_retries)
            if attempt >= budget:
                # once per exhaustion: an alert newer than the task's
                # final failure means it is already on record
                prior = self.session.query_one(
                    "SELECT id FROM alert WHERE rule='retry-exhausted' "
                    "AND task=? AND time >= ? LIMIT 1",
                    (task.id, task.finished or task.last_activity))
                if prior is None:
                    AlertProvider(self.session).raise_alert(
                        'retry-exhausted',
                        f'task {task.id} ({task.name}): {attempt} '
                        f'retr{"y" if attempt == 1 else "ies"} '
                        f'exhausted (last failure: {reason})',
                        task=task.id, dag=task.dag,
                        computer=task.computer_assigned,
                        severity='critical',
                        details={'attempt': attempt, 'reason': reason})
                    self.aux.setdefault('retry_exhausted',
                                        []).append(task.id)
                continue
            if task.next_retry_at is None:
                delay = retry_delay_s(attempt, cfg, task_id=task.id)
                task.next_retry_at = now_dt + \
                    datetime.timedelta(seconds=delay)
                self.provider.update(task, ['next_retry_at'])
                self.aux.setdefault('retry_scheduled', {})[task.id] = \
                    str(task.next_retry_at)
                continue
            due = parse_datetime(task.next_retry_at)
            if due is not None and due > now_dt:
                continue
            self.retry_task(task, reason)

    def retry_task(self, task: Task, reason: str):
        """Requeue one transiently Failed task: attempt + 1, resume info
        attached (training restores the last checkpoint), the failing
        computer (for a gang: the computers of its root-cause ranks)
        excluded, and a ``task.retry`` metric row written. (A gang's
        sharded-checkpoint coverage check before re-dispatch comes with
        the fan-out, A4; the resume blob is kept, as the JAX tick keeps
        it where the folder is not visible.)"""
        from mlcomp_tpu_torch.recovery import (
            GANG_COLLATERAL_REASONS, find_resume_info, reset_for_requeue,
        )
        exclude = task.computer_assigned
        reshapeable = None
        if task.gang_id:
            exclude = sorted({
                c.computer_assigned for c in self.provider.children(
                    task.id, statuses=[TaskStatus.Failed])
                if c.computer_assigned and c.failure_reason
                and c.failure_reason not in GANG_COLLATERAL_REASONS
            }) or None
            from mlcomp_tpu_torch.parallel.meshspec import (
                mesh_reshapeable,
            )
            mesh = _info(task).get('mesh')
            try:
                reshapeable = mesh_reshapeable(
                    mesh if isinstance(mesh, dict) else None)
            except ValueError:
                reshapeable = None
        try:
            resume = find_resume_info(self.provider, task)
        except LookupError:
            resume = None       # no rank-0 child: restart from scratch
        task.attempt = (task.attempt or 0) + 1
        if task.gang_id:
            task.gang_generation = \
                max(1, int(task.gang_generation or 0)) + 1
        reset_for_requeue(self.provider, task, resume=resume,
                          exclude_computer=exclude)
        rows = [(task.id, 'task.retry', 'counter', task.attempt, 1.0,
                 now(), 'supervisor', json.dumps({'reason': reason}))]
        if task.gang_id:
            rows.append((
                task.id, 'gang.generation', 'counter',
                task.gang_generation, 1.0, now(), 'supervisor',
                json.dumps({'gang': task.gang_id, 'reason': reason})))
        try:
            MetricProvider(self.session).add_many(rows)
        except Exception:
            pass                # observability must not block the retry
        self.aux.setdefault('retried', []).append(
            {'task': task.id, 'attempt': task.attempt,
             'reason': reason, 'excluded': exclude,
             'gang': task.gang_id,
             'generation': task.gang_generation if task.gang_id
             else None,
             'mesh_reshapeable': reshapeable})
        self._log_warning(
            f'task {task.id} ({task.name}): retry {task.attempt} after '
            f'{reason} — requeued with resume'
            + (f', excluding {exclude}' if exclude else ''), task.id)

    # ------------------------------------------------------------ placement
    def dag_preflight_errors(self, dag_id: int) -> list:
        """Error findings of a dag from its STORED config and code,
        computed once per supervisor lifetime: a dag that reached the
        DB around the submit gate is refused dispatch. An analyzer
        crash never blocks ([])."""
        if dag_id in self._preflight_cache:
            return self._preflight_cache[dag_id]
        errors = []
        try:
            from mlcomp_tpu_torch.analysis import (
                preflight_config, snapshot_sources, split_findings,
            )
            dag = self.dag_provider.by_id(dag_id)
            config = yaml_load(dag.config) if dag and dag.config else None
            if isinstance(config, dict):
                findings = preflight_config(
                    config, sources=snapshot_sources(self.session, dag_id))
                errors, _ = split_findings(findings)
            if errors:
                provider = DagPreflightProvider(self.session)
                provider.clear(dag_id, source='supervisor')
                provider.add_findings(dag_id, errors, source='supervisor')
                self._log_error(
                    f'dag {dag_id} failed preflight; refusing to dispatch '
                    f'its tasks: ' + '; '.join(
                        f'[{f.rule}] {f.message}' for f in errors))
        except Exception:
            errors = []
            self._log_error(f'preflight of dag {dag_id} crashed (not '
                            f'blocking):\n{traceback.format_exc()}')
        self._preflight_cache[dag_id] = errors
        return errors

    def process_tasks(self):
        """Preflight and dependency gating, then placement. A failure
        placing one task is logged and the task stays NotRan."""
        bad = {int(TaskStatus.Failed), int(TaskStatus.Stopped),
               int(TaskStatus.Skipped)}
        unfinished = {int(TaskStatus.NotRan), int(TaskStatus.Queued),
                      int(TaskStatus.InProgress)}
        for task in self.tasks:
            preflight_errors = self.dag_preflight_errors(task.dag)
            if preflight_errors:
                self.provider.change_status(task, TaskStatus.Skipped)
                self.aux.setdefault('preflight_blocked', {})[task.id] = [
                    f'[{f.rule}] {f.message}' for f in preflight_errors]
                continue
            deps = self.dep_status.get(task.id, set())
            if deps & bad:
                self.provider.change_status(task, TaskStatus.Skipped)
                continue
            if deps & unfinished:
                continue
            try:
                self.process_task(task)
            except FenceLostError:
                raise       # zombie leader: stop the tick, demote
            except Exception:
                self._log_error(f'failed processing task {task.id}:\n'
                                f'{traceback.format_exc()}', task.id)

    def refuse_preemption(self):
        """The JAX tick's preemption pass evicts strictly-lower-class
        busy work for a capacity-blocked task above ``preemptible``.
        Where it could, this raises instead of leaving the blocked task
        waiting behind work JAX would have evicted."""
        if not self._capacity_blocked:
            return
        from mlcomp_tpu_torch.server.scheduler import (
            PRIORITY_RANK, task_priority_of,
        )
        ranks = []
        parents = {}
        for t in self.provider.by_status(TaskStatus.Queued,
                                         TaskStatus.InProgress):
            if not t.computer_assigned or not t.cores_assigned \
                    or t.cores_assigned == '[]':
                continue
            unit = t
            if t.parent is not None:
                if t.parent not in parents:
                    parents[t.parent] = self.provider.by_id(t.parent)
                unit = parents[t.parent] or t
            ranks.append(PRIORITY_RANK.get(task_priority_of(unit), 1))
        for task in self._capacity_blocked:
            rank = PRIORITY_RANK.get(task_priority_of(task), 1)
            if rank > PRIORITY_RANK['preemptible'] and \
                    any(r < rank for r in ranks):
                raise _refusal(
                    f'preempting lower-class work for task {task.id}',
                    'quotas and preemption')

    def write_auxiliary(self):
        """Persist the tick's decision trace."""
        self.auxiliary_provider.create_or_update('supervisor', self.aux)

    def record_fence_rejections(self):
        """Writes the epoch fence rejected since the last tick, as a
        ``supervisor.fenced_writes`` counter row (``/metrics`` sums
        them): rare, and each one is a failover story."""
        rejections = fence_rejections()
        delta = rejections - self._fence_seen
        if delta > 0:
            MetricProvider(self.raw_session).add_many([
                (None, 'supervisor.fenced_writes', 'counter', None,
                 float(delta), now(), 'supervisor', None)])
        self._fence_seen = rejections

    # ---------------------------------------------------------------- main
    def build(self):
        """One tick. A failing tick heals by rebuilding the builder on a
        fresh session; a refusal (``NotImplementedError``) and a fenced
        write (``FenceLostError``: a newer leader exists) propagate."""
        from mlcomp_tpu_torch.telemetry import flush_spans
        start = now()
        try:
            self.refuse_unported()
            self.create_base()
            self.process_parent_tasks()
            # recovery before load_tasks: a task requeued this tick
            # re-loads as NotRan and can re-dispatch at once
            self.process_recovery()
            self.load_tasks()
            self.load_computers()
            self.process_tasks()
            self.refuse_preemption()
            self.aux['duration'] = (now() - start).total_seconds()
            self.write_auxiliary()
            self.record_fence_rejections()
            flush_spans(self.session)
            # the pending index is tick-scoped
            self._pending_execute = None
        except (NotImplementedError, FenceLostError):
            # a refusal, or a NEWER LEADER exists and the store rejected
            # this zombie's write: the loop demotes instead of healing
            # the session and retrying the same stale writes
            raise
        except Exception:
            self._log_error(f'supervisor tick failed:\n'
                            f'{traceback.format_exc()}')
            # create_session is a keyed singleton: drop the cached
            # (possibly wedged) connection so a fresh one is built; the
            # connection string is kept (the JAX heal path reconnects
            # to the default DB)
            key = getattr(self.raw_session, 'key', 'supervisor')
            connection_string = self.raw_session.connection_string
            Session.cleanup(key)
            fresh = Session.create_session(
                key=key, connection_string=connection_string)
            if self.logger is not None:
                # the cached logger's DB handler holds the old session
                from mlcomp_tpu_torch.utils.logging import create_logger
                self.logger = create_logger(fresh)
            lease = self.lease
            if lease is not None:
                # the lease handle follows the healed connection
                from mlcomp_tpu_torch.db.providers.supervisor import (
                    SupervisorLeaseProvider,
                )
                lease.session = fresh
                lease.provider = SupervisorLeaseProvider(fresh)
            self.__init__(session=fresh, logger=self.logger,
                          queue_liveness_window=self.queue_liveness_window,
                          recovery_config=self.recovery_config,
                          lease=lease)


class SupervisorLoop(threading.Thread):
    """Wake-on-work supervisor loop: ``builder.build()``, then sleep on
    the event bus (db/events.py) until a task appears or changes status
    (``tasks``) or a queue message completes (``queue:done``), with
    ``interval`` as the timer backstop for the clock-driven work (lease
    reclaim, retry backoff). On sqlite, events reach only this
    process's waiters; work submitted from another process is picked up
    at the backstop.

    The event snapshot is taken BEFORE build() runs, so work submitted
    while a tick is in flight wakes the next wait at once.

    **High availability** (server/ha.py): with a ``lease`` the loop is
    one contender in the leader election. A standby parks on the
    ``supervisor:lease`` channel and promotes within one lease window of
    the leader's silence, or at once when a leader in this process
    releases (a standby in another process retries every third of the
    window: sqlite carries no event across processes). Promotion runs
    ``reconcile_dispatches`` before the first tick and writes a
    ``supervisor.failover`` row; a failed renew or a ``FenceLostError``
    out of a tick demotes the process to standby."""

    WAKE_CHANNELS = (CH_TASKS, CH_QUEUE_DONE)

    #: pause between an event wakeup and its tick: a submit burst
    #: coalesces into one build
    DEBOUNCE_S = 0.05

    def __init__(self, builder: SupervisorBuilder, interval: float = 1.0,
                 lease=None):
        super().__init__(daemon=True, name='supervisor-loop')
        self.builder = builder
        self.interval = interval
        self.lease = lease if lease is not None else builder.lease
        self.wake_events = 0        # ticks triggered by an event
        self.wake_timer = 0         # ticks triggered by the backstop
        self.promotions = 0         # standby -> leader transitions
        self.demotions = 0          # leader -> standby transitions
        self._was_leader = False
        # NOT named _stop: threading.Thread.join() calls self._stop()
        self._stop_evt = threading.Event()

    # ------------------------------------------------------------- HA
    def _ha_gate(self) -> bool:
        """One election step: True when this process leads and should
        tick; False as a standby (already parked on the lease channel).
        Promotion runs the half-dispatch sweep and writes the
        ``supervisor.failover`` row."""
        try:
            leading = self.lease.ensure()
        except Exception:
            # the election needs the DB: a sick store is standby, retried
            # at the backstop
            self._stop_evt.wait(self.interval)
            return False
        if leading and not self._was_leader:
            self._was_leader = True
            self.promotions += 1
            self._on_promote()
        elif not leading and self._was_leader:
            self._was_leader = False
            self.demotions += 1
            self._log(f'supervisor {self.lease.holder}: demoted — a '
                      f'newer leader holds the lease')
        if not leading and not self._stop_evt.is_set():
            self.lease.wait_standby()
        return leading

    def _fence_demote(self):
        """Demote after a FenceLostError. ``_was_leader`` resets too: a
        later re-acquisition is a fresh promotion, whose sweep and
        failover row must run again."""
        if self.lease is not None:
            self.lease.epoch = None
            self.lease.demotions += 1
        if self._was_leader:
            self._was_leader = False
            self.demotions += 1
            self._log(f'supervisor {self.lease.holder}: demoted — a '
                      f'write was fenced off by a newer epoch')

    def _on_promote(self):
        epoch = self.lease.epoch
        self._log(f'supervisor {self.lease.holder}: promoted to leader '
                  f'at epoch {epoch}')
        builder = self.builder
        try:
            builder.create_base()
            builder.reconcile_dispatches()
        except Exception:
            self._log(f'promotion sweep failed (continuing):\n'
                      f'{traceback.format_exc()}', error=True)
        try:
            # one row per promotion; epoch 1 is the first boot, not a
            # failover, and is tagged so the /metrics counter skips it
            MetricProvider(builder.raw_session).add_many([
                (None, 'supervisor.failover', 'counter', int(epoch or 0),
                 1.0, now(), 'supervisor',
                 json.dumps({'holder': self.lease.holder,
                             'epoch': int(epoch or 0),
                             'first_boot': int(epoch == 1)}))])
        except Exception:
            pass

    def _log(self, msg: str, error: bool = False):
        logger = self.builder.logger
        try:
            if logger is None:
                print(msg)
            elif error:
                logger.error(msg, ComponentType.Supervisor)
            else:
                logger.warning(msg, ComponentType.Supervisor)
        except Exception:
            pass

    def run(self):
        while not self._stop_evt.is_set():
            if self.lease is not None and not self._ha_gate():
                continue
            session = self.builder.session
            try:
                snapshot = session.event_snapshot(self.WAKE_CHANNELS)
            except Exception:
                snapshot = None
            try:
                self.builder.build()
            except FenceLostError:
                # the store rejected this process's epoch mid-tick: a
                # newer leader exists
                self._fence_demote()
                continue
            except Exception:
                # a refusal, or the heal path itself failing: the loop
                # survives and retries at the backstop
                self._log(f'supervisor loop tick failed:\n'
                          f'{traceback.format_exc()}', error=True)
                self._stop_evt.wait(self.interval)
                continue
            if self._stop_evt.is_set():
                break
            try:
                woke = session.wait_event(
                    self.WAKE_CHANNELS, self.interval, snapshot=snapshot)
            except Exception:
                self._stop_evt.wait(self.interval)
                continue
            if woke:
                self.wake_events += 1
                self._stop_evt.wait(self.DEBOUNCE_S)
            else:
                self.wake_timer += 1

    def stop(self):
        """Graceful shutdown: the lease is released at once (not left to
        expire), so a standby need not wait out the window."""
        self._stop_evt.set()
        if self.lease is not None:
            try:
                self.lease.release()
            except Exception:
                pass        # expiry remains the backstop
        # unblock a waiting loop now instead of at the backstop,
        # whichever channel it is parked on
        from mlcomp_tpu_torch.db import events
        events.publish(CH_TASKS)
        events.publish(CH_SUPERVISOR_LEASE)


def register_supervisor(session: Session = None, logger=None,
                        interval: float = 1.0, ha: bool = True,
                        lease_seconds: float = None):
    """Start the supervisor loop on a background thread; returns
    ``(builder, [loop])`` (``loop.stop()`` ends it). With ``ha=True``
    (the default) the loop contends for the ``supervisor_lease`` leader
    election (server/ha.py): alone it acquires at once, and any further
    supervisor becomes a hot standby; every control-state write is
    epoch-fenced (db/fencing.py). ``ha=False`` runs a lease-less
    loop."""
    session = session or Session.create_session(key='supervisor')
    lease = None
    if ha:
        from mlcomp_tpu_torch.server.ha import (
            DEFAULT_LEASE_SECONDS, LeaderLease,
        )
        lease = LeaderLease(
            session, lease_seconds=lease_seconds or DEFAULT_LEASE_SECONDS)
    builder = SupervisorBuilder(session=session, logger=logger, lease=lease)
    loop = SupervisorLoop(builder, interval=interval, lease=lease)
    loop.start()
    return builder, [loop]


__all__ = ['SupervisorBuilder', 'SupervisorLoop', 'register_supervisor',
           'STALL_DEADLINE_S']

"""Supervisor — the scheduling tick (port of
``mlcomp_tpu/server/supervisor.py``).

Each tick (``SupervisorBuilder.build``):

1. ``create_base``          — live queues from docker heartbeats (< 15 s)
2. ``process_parent_tasks`` — child→parent status aggregation; a failed
   child gang-aborts its siblings
3. ``process_recovery``     — lease reclaim (an InProgress claim only
   past the watchdog's ``stall_deadline_s``), strand sweep, retry of
   transient failures (a preempted or stall-killed task among them) with
   backoff and resume from the last checkpoint
4. ``process_sweeps``       — the ASHA sweep scheduler
   (server/sweep.py): judges grid cells at budget rungs, prunes the
   losers (``Failed``/``sweep-pruned``), finishes done sweeps; a pruned
   cell's slot re-places in the same tick
5. ``process_fleets``       — the serving-fleet reconciler
   (server/fleet.py): desired replica counts, health-gated respawn,
   rolling swaps; a replica task it mints dispatches in the same tick
6. ``load_tasks``           — NotRan tasks in dispatch order (class,
   aging, fair share over the usage ledger's window, age) + their
   dependency status sets
7. ``load_computers``       — free-resource model per computer: card
   slot array + cpu + memory, minus Queued/InProgress assignments
8. ``process_tasks``        — preflight and dependency gating
   (failed dependency → Skipped), quota admission (a tenant at its
   ceiling waits, ``critical`` exempt), then placement and dispatch onto
   the DB queue ``{computer}_{docker}``; sweep cells steer off hosts
   with a history of transient failures
9. ``process_preemptions``  — the checkpoint-preemption engine: repair
   of decisions a dead leader recorded but never applied, then eviction
   of strictly-lower-class work for the tasks placement could not fit
   (decision row first, kill second; at most 8 a tick)
10. ``process_usage``       — the usage ledger: every terminal task
    attempt folded exactly once (a victim in the tick that evicted it)
11. ``run_watchdog``        — the health rules (telemetry/watchdog.py,
    rate-limited to ``evaluate_every_s``) into ``alert`` rows; a
    ``task-stall`` is failed ``stall-killed`` and killed, a
    ``gang-stall`` rank failed ``worker-lost`` and its gang aborted
12. ``run_slo``             — the SLO burn-rate engine
    (telemetry/slo.py, rate-limited the same way): ``slo.*`` rows,
    ``slo-*`` alerts raised and auto-resolved
13. ``write_auxiliary``     — the decision trace into ``auxiliary``
14. ``record_tick_telemetry`` — the tick's gauges into its recorder
    (``supervisor.tick_ms``, the ``db.*`` and ``supervisor.fenced_writes``
    deltas, the dispatch-latency and per-class queue-wait histograms,
    the ``queue.max_wait_s.<class>`` starvation gauges), then the
    dispatch spans flushed

The recorder (``self.telemetry``, component ``supervisor``) buffers in
memory and writes one batch every 60 samples, about a minute of ticks;
the sweep scheduler, the fleet reconciler, recovery, preemption and the
usage fold count into it too.

With a :class:`~mlcomp_tpu_torch.server.ha.LeaderLease` (HA, the
default of ``register_supervisor``) the builder issues every write on a
:class:`~mlcomp_tpu_torch.db.fencing.FencedSession`: each mutation of a
control-state table carries the leader's epoch, so a paused ex-leader's
writes are rejected in the DB. The loop contends for the lease, runs
``reconcile_dispatches`` at promotion and releases the lease when it
stops.

What the JAX tick does beyond this: the multi-host fan-out (A4) raises
``NotImplementedError``, in placement and where the preemption engine
would evict for a gang, before any decision row.
"""

import datetime
import json
import threading
import time
import traceback

from mlcomp_tpu_torch import MASTER_PORT_RANGE
from mlcomp_tpu_torch.db.core import (
    Session, busy_retry_stats, parse_datetime,
)
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus, TaskType
from mlcomp_tpu_torch.db.events import (
    CH_QUEUE_DONE, CH_SUPERVISOR_LEASE, CH_TASKS, listener_stats,
)
from mlcomp_tpu_torch.db.fencing import (
    FencedSession, FenceLostError, fence_rejections,
)
from mlcomp_tpu_torch.db.models import QueueMessage, Task
from mlcomp_tpu_torch.db.providers import (
    AlertProvider, AuxiliaryProvider, ComputerProvider, DagPreflightProvider,
    DagProvider, DockerProvider, MetricProvider, PreemptionProvider,
    QueueProvider, QuotaProvider, TaskProvider, UsageProvider,
)
from mlcomp_tpu_torch.recovery import RecoveryConfig
from mlcomp_tpu_torch.telemetry import (
    MetricRecorder, SloEngine, Watchdog, flush_spans,
)
from mlcomp_tpu_torch.testing.faults import fault_point
from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.utils.misc import now

#: queue-wait histogram bucket bounds (seconds): an event-driven
#: same-tick claim (sub-second) through a starved class waiting hours;
#: +Inf is implicit (telemetry Histogram)
QUEUE_WAIT_BUCKETS_S = (1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
                        600.0, 1800.0, 3600.0)

#: tables whose rows only unported parts of the JAX tick act on, each
#: with the ROADMAP.md item that brings it (none at present)
UNPORTED_TABLES = ()


def _refusal(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not ported yet (ROADMAP.md, A0: {item})')


def _info(task: Task) -> dict:
    return (yaml_load(task.additional_info)
            if task.additional_info else {}) or {}


class SupervisorBuilder:
    def __init__(self, session: Session = None, logger=None,
                 queue_liveness_window: float = 15.0,
                 recovery_config: RecoveryConfig = None, fleet_config=None,
                 fleet_probe=None, lease=None):
        from mlcomp_tpu_torch.server.fleet import FleetReconciler
        from mlcomp_tpu_torch.server.sweep import SweepScheduler
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
        self.fleet_config = fleet_config
        self.fleet_probe = fleet_probe
        self.provider = TaskProvider(self.session)
        self.computer_provider = ComputerProvider(self.session)
        self.docker_provider = DockerProvider(self.session)
        self.queue_provider = QueueProvider(self.session)
        self.dag_provider = DagProvider(self.session)
        self.auxiliary_provider = AuxiliaryProvider(self.session)
        # tick telemetry: gauges, counts and histograms buffered in
        # memory, one DB batch per 60 samples (~1/min at the 1 Hz tick)
        self.telemetry = MetricRecorder(
            session=self.session, component='supervisor',
            flush_every=60)
        # health watchdog and SLO burn-rate engine: consumers of the
        # telemetry in the DB, each rate-limited inside the tick to its
        # ``evaluate_every_s`` (an off-cadence tick pays a clock read)
        self.watchdog = Watchdog(self.session, logger=logger)
        self.slo_engine = SloEngine(self.session, logger=logger)
        # serving-fleet reconciler (server/fleet.py): runs inside the
        # tick before load_tasks, so a spawned replica task dispatches
        # on the same tick through the normal placement path
        self.fleet_reconciler = FleetReconciler(
            self.session, logger=logger, config=fleet_config,
            probe=fleet_probe, telemetry=self.telemetry)
        # ASHA sweep scheduler (server/sweep.py): judges grid cells at
        # budget rungs off the sweep.score series and prunes the
        # losers — runs before load_tasks so a pruned cell's slot
        # re-places into the next queued cell in the SAME tick
        self.sweep_scheduler = SweepScheduler(
            self.session, logger=logger, telemetry=self.telemetry,
            gang_abort=self.gang_abort)
        # the usage ledger's fold, quota admission and the preemption
        # audit trail, all on the fenced session: a zombie ex-leader can
        # neither double-bill, double-preempt nor deny admission
        self.usage_provider = UsageProvider(self.session)
        self.quota_provider = QuotaProvider(self.session)
        self.preemption_provider = PreemptionProvider(self.session)

        self.queues = []
        self.alive_computers = set()
        self.tasks = []
        self.dep_status = {}
        self.computers = []
        self.aux = {}
        # per-tick scheduling snapshot (quota limits, live cores,
        # windowed core-seconds); None = not read this tick
        self._sched_snapshot = None
        # this tick's placements that failed for capacity, as
        # ``{task, need, grain, multi}``: the preemption engine's worklist
        self._capacity_blocked = []
        # computer -> transient-failure count for the sweep cells'
        # placement; tick-scoped, None = not read this tick
        self._retry_prone = None
        # dag id -> [error findings] ([] = passed), filled the first
        # time a NotRan task of that dag reaches placement
        self._preflight_cache = {}
        # (queue, payload) -> pending msg id, loaded once per tick so
        # dispatch's restart-idempotency check costs no round trip per
        # task; None outside a tick (dispatch falls back to find_active)
        self._pending_execute = None
        # claims already observed into the dispatch-latency and
        # queue-wait histograms
        self._last_claim_ts = now()
        # process-wide counters already folded into the db.busy_*,
        # db.listener_reconnects and supervisor.fenced_writes deltas
        self._busy_seen = busy_retry_stats()
        self._listener_seen = listener_stats()
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
        self._retry_prone = None

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
            self.telemetry.count('supervisor.gang_aborted_ranks',
                                 len(aborted))
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
        """(limits, live, windowed): the quota table, live cores and the
        ledger window's core-seconds, read ONCE per tick. ``limits`` maps
        (scope, tenant, resource) -> (limit, window_s); ``live`` and
        ``windowed`` map (scope, tenant) -> cores / core-seconds. Later
        dispatches of the same tick bill into ``live`` (``_bill_live``),
        so a burst cannot leak past a ceiling. A read failure admits
        every tenant unlimited: quota must never stop scheduling."""
        if self._sched_snapshot is not None:
            return self._sched_snapshot
        limits, live, windowed = {}, {}, {}
        try:
            quotas = self.quota_provider.all()
            for q in quotas:
                limits[(q.scope, q.tenant, q.resource)] = (
                    float(q.limit_value or 0.0),
                    float(q.window_s or 86400.0))
            if limits:
                for scope in {q.scope for q in quotas}:
                    for tenant, cores in \
                            self.quota_provider.live_cores(scope).items():
                        live[(scope, tenant)] = cores
                    window = max(
                        [w for (sc, _t, r), (_l, w) in limits.items()
                         if sc == scope and r == 'core_seconds'],
                        default=86400.0)
                    for tenant, cs in self.quota_provider \
                            .window_core_seconds(scope, window).items():
                        windowed[(scope, tenant)] = cs
        except Exception:
            limits, live, windowed = {}, {}, {}
            self._log_error(f'quota snapshot failed (admitting '
                            f'unlimited):\n{traceback.format_exc()}')
        self._sched_snapshot = (limits, live, windowed)
        return self._sched_snapshot

    def _bill_live(self, task: Task, cores_n: int):
        """Count a dispatch against the snapshot's live cores, so later
        admissions of the same tick see it."""
        if self._sched_snapshot is None or not cores_n:
            return
        _limits, live, _windowed = self._sched_snapshot
        for scope, tenant in (('owner', task.owner or 'default'),
                              ('project', task.project or 'default')):
            live[(scope, tenant)] = \
                live.get((scope, tenant), 0) + int(cores_n)

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
        # preemption-aware placement of SWEEP cells: a cell is
        # disposable work, so steer it off hosts whose recovery history
        # says they eat tasks (transient failure verdicts). The sort is
        # stable: equal-history hosts keep the packing order, and
        # non-sweep tasks are untouched
        if info.get('sweep') and len(fits) > 1:
            prone = self._retry_prone_counts()
            if any(prone.get(c['name']) for c in fits):
                fits.sort(key=lambda c: prone.get(c['name'], 0))
        return fits, reasons

    def _retry_prone_counts(self) -> dict:
        """computer -> count of transient-failure verdicts attributed
        to it (terminal task rows whose ``failure_reason`` is in the
        recovery taxonomy's transient set). One grouped query, cached
        per tick; the status filter in SQL keeps the read on the status
        index."""
        if self._retry_prone is not None:
            return self._retry_prone
        from mlcomp_tpu_torch.recovery import TRANSIENT_REASONS
        reasons = sorted(TRANSIENT_REASONS)
        marks = ','.join('?' * len(reasons))
        try:
            self._retry_prone = {
                r['computer_assigned']: r['n']
                for r in self.session.query(
                    f'SELECT computer_assigned, COUNT(*) AS n '
                    f'FROM task WHERE status IN (?, ?) '
                    f'AND failure_reason IN ({marks}) '
                    f'AND computer_assigned IS NOT NULL '
                    f'GROUP BY computer_assigned',
                    (int(TaskStatus.Failed), int(TaskStatus.Stopped),
                     *reasons))}
        except Exception:
            self._retry_prone = {}
        return self._retry_prone

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
        """Placement + dispatch of one runnable task onto one computer,
        behind quota admission (``server/scheduler.py`` ``quota_block``):
        a tenant at its cores ceiling, or past its core-seconds window,
        is refused placement this tick; ``critical`` work is exempt. A
        task that asks for distributed execution over several computers
        raises: the multi-host fan-out is A4."""
        from mlcomp_tpu_torch.parallel.meshspec import (
            check_mesh_spec, host_grant_granularity,
        )
        from mlcomp_tpu_torch.server.scheduler import (
            quota_block, task_priority_of,
        )
        limits, live, windowed = self._scheduling_snapshot()
        if limits:
            block = quota_block(
                task_priority_of(task), int(task.cores or task.cores_max
                                            or 0),
                task.owner, task.project, limits, live, windowed)
            if block:
                self.aux.setdefault('not_placed', {})[task.id] = {
                    'quota': block}
                self.telemetry.count('scheduler.quota_denied')
                return
        info = _info(task)
        fits, reasons = self._candidate_computers(task)
        if not fits:
            self.aux.setdefault('not_placed', {})[task.id] = reasons
            # a FULL pool rejects every computer with the capacity
            # verdict: still a preemption candidate
            if any(str(r).startswith('no free cores')
                   for r in reasons.values()):
                multi = (task.cores_max or 0) > 1 \
                    and not task.single_node \
                    and bool(info.get('distr', task.cores_max > 1))
                mesh = info.get('mesh') \
                    if isinstance(info.get('mesh'), dict) else None
                self._capacity_blocked.append(
                    {'task': task, 'need': int(task.cores or 0),
                     'grain': int(host_grant_granularity(mesh))
                     if multi else 0, 'multi': multi})
            return
        distr = bool(info.get('distr', task.cores_max > 1))
        mesh_spec = info.get('mesh') \
            if isinstance(info.get('mesh'), dict) else None
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
            # a capacity shortfall: the preemption engine may evict
            # lower-class work for it this tick
            self._capacity_blocked.append(
                {'task': task, 'need': int(need), 'grain': 0,
                 'multi': False})
            return
        queue = self.dispatch(task, comp, cores)
        self._bill_live(task, len(cores))
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

    def process_sweeps(self):
        """ASHA sweep scheduling (server/sweep.py): judge every cell
        that reported a budget rung, prune the losers through the
        kill/taxonomy path, finish completed sweeps. Runs before
        load_tasks so a pruned cell's cores are free for this tick's
        placement. Same containment as recovery: a scheduler crash
        never takes the tick down, a fence loss demotes this leader."""
        try:
            sweep_aux = self.sweep_scheduler.tick()
            if sweep_aux:
                self.aux['sweeps'] = sweep_aux
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'sweep scheduling failed:\n'
                            f'{traceback.format_exc()}')

    def process_fleets(self):
        """Serving-fleet reconciliation (server/fleet.py). Same
        containment as recovery: a reconciler crash never takes the
        tick down (per-fleet crashes are contained inside ``tick()``)."""
        try:
            fleet_aux = self.fleet_reconciler.tick()
            if fleet_aux:
                self.aux['fleets'] = fleet_aux
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'fleet reconciliation failed:\n'
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
                # reclaimed only once its own silence passes the
                # watchdog's stall deadline, the system's definition of
                # "dead quiet" (a run dead past it is stall-killed at
                # that same horizon anyway)
                last = parse_datetime(task.last_activity)
                horizon = max(
                    lease, float(self.watchdog.config.stall_deadline_s))
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
            self.telemetry.count('supervisor.lease_reclaimed')
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
            self.telemetry.count('supervisor.gang_requeues')
        try:
            MetricProvider(self.session).add_many(rows)
        except Exception:
            pass                # observability must not block the retry
        self.telemetry.count('supervisor.task_retries')
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

    # ---------------------------------------------------------- preemption
    def process_preemptions(self):
        """Checkpoint-preemption: where a higher-class placement could
        not fit this tick, evict strictly-lower-class work. The decision
        row comes FIRST (exactly once per victim attempt, epoch-fenced),
        the kill second, so a leader killed between the two leaves an
        unapplied row the next leader's repair finishes: never a lost
        victim, never a double eviction. Victims fail with the transient
        reason ``preempted``, so the retry pass requeues them once with
        backoff and resume; their cores re-place next tick, where the
        blocked task sorts first by class. A crash here never takes the
        tick down; a fence loss demotes this leader. The pass's wall
        goes into ``supervisor.preempt_ms``."""
        t0 = time.monotonic()
        try:
            self._repair_preemptions()
            self._preempt_for_blocked()
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'preemption pass failed:\n'
                            f'{traceback.format_exc()}')
        self.telemetry.gauge('supervisor.preempt_ms',
                             round((time.monotonic() - t0) * 1e3, 3))

    def _repair_preemptions(self):
        """Finish decisions a dead leader recorded but never applied. A
        decision whose victim is gone, already terminal or on a NEWER
        attempt is closed without action: re-killing it would be the
        double preemption the audit trail exists to prevent."""
        live = {int(TaskStatus.NotRan), int(TaskStatus.Queued),
                int(TaskStatus.InProgress)}
        for dec in self.preemption_provider.unapplied():
            victim = self.provider.by_id(dec.task)
            if victim is None or int(victim.status) not in live \
                    or int(victim.attempt or 0) != int(dec.attempt or 0):
                self.preemption_provider.mark_applied(
                    dec.task, dec.attempt or 0)
                continue
            self._apply_preemption(victim, dec.reason or 'capacity',
                                   repair=True)

    def _victim_candidates(self) -> dict:
        """``{computer: [victim dicts]}`` over the busy task rows. The
        unit of eviction is the RETRYABLE row (a gang rank's parent, else
        the task itself); the cores counted are the LOCAL slice, so a
        gang parent on several hosts frees each host's slice with one
        preemption."""
        from mlcomp_tpu_torch.server.scheduler import task_priority_of
        now_dt = now()
        parents = {}
        out = {}
        for t in self.provider.by_status(
                TaskStatus.Queued, TaskStatus.InProgress):
            if not t.computer_assigned or not t.cores_assigned:
                continue
            try:
                local = len(json.loads(t.cores_assigned))
            except (TypeError, ValueError):
                local = int(t.cores or 0)
            if not local:
                continue
            unit = t
            if t.parent is not None:
                if t.parent not in parents:
                    parents[t.parent] = self.provider.by_id(t.parent)
                unit = parents[t.parent]
                if unit is None:
                    continue
            started = t.started or t.last_activity
            run_s = max(0.0, (now_dt - started).total_seconds()) \
                if started else 0.0
            out.setdefault(t.computer_assigned, []).append({
                'task_id': int(unit.id), 'unit': unit,
                'priority': task_priority_of(unit),
                'cores': local, 'run_s': run_s,
                'gang': bool(unit.gang_id)})
        return out

    def _plan_for(self, blocked: dict, rank: int, victims_by_comp,
                  chosen_ids):
        """The victims that let one blocked ask fit, or []: the cheapest
        per-computer plan (fewest victims, then least sunk cost). Victims
        chosen for a stronger blocked task this tick are off the table.
        A gang's ask (``multi``) would be placed by the multi-host
        fan-out, which is A4: it raises here, before any decision row,
        so nothing is evicted for an ask the port cannot place."""
        from mlcomp_tpu_torch.server.scheduler import (
            plan_single_node, victim_cost,
        )
        task = blocked['task']
        if blocked['multi']:
            raise NotImplementedError(
                f'preempting for task {task.id}, a gang over several '
                f'computers: the multi-host fan-out is not ported yet '
                f'(ROADMAP.md, A4)')
        best = None
        for comp in self.computers:
            reason = self._valid_computer(task, comp)
            # a FULL host is where preemption applies: only the capacity
            # verdict is ignorable here
            if reason and not reason.startswith('no free cores'):
                continue
            victims = [v for v in victims_by_comp.get(comp['name'], [])
                       if v['task_id'] not in chosen_ids]
            plan = plan_single_node(
                blocked['need'], len(self._free_cores(comp)), victims,
                rank)
            if not plan:        # fits free, or no plan
                continue
            key = (len(plan), sum(victim_cost(v) for v in plan))
            if best is None or key < best[0]:
                best = (key, plan)
        return best[1] if best else []

    def _preempt_for_blocked(self):
        """Evict for this tick's capacity-blocked tasks, strongest CLASS
        first: aging earns earlier dispatch, never the power to evict,
        so even an aged ``preemptible`` task evicts nobody. At most
        ``MAX_PREEMPTIONS_PER_TICK`` victims a tick."""
        if not self._capacity_blocked:
            return
        from mlcomp_tpu_torch.server.scheduler import (
            MAX_PREEMPTIONS_PER_TICK, PRIORITY_RANK, task_priority_of,
        )
        victims_by_comp = self._victim_candidates()
        if not victims_by_comp:
            return
        budget = MAX_PREEMPTIONS_PER_TICK
        chosen = set()
        blocked = sorted(
            self._capacity_blocked,
            key=lambda b: (-PRIORITY_RANK.get(
                task_priority_of(b['task']), 1), int(b['task'].id)))
        for b in blocked:
            if budget <= 0:
                break
            rank = PRIORITY_RANK.get(task_priority_of(b['task']), 1)
            if rank <= PRIORITY_RANK['preemptible']:
                continue        # the lowest class never evicts anyone
            try:
                plan = self._plan_for(b, rank, victims_by_comp, chosen)
            except NotImplementedError:
                self._log_error(f'failed preempting for task '
                                f'{b["task"].id}:\n'
                                f'{traceback.format_exc()}', b['task'].id)
                continue
            for v in plan:
                if budget <= 0:
                    break
                if v['task_id'] in chosen:
                    continue
                if self._preempt_victim(v['unit'], b['task'], 'capacity',
                                        v['cores']):
                    chosen.add(v['task_id'])
                    budget -= 1

    def _preempt_victim(self, victim: Task, initiator: Task,
                        reason: str, cores_freed: int) -> bool:
        """Decision row first, kill second. The conditional insert is
        the linearization point: whoever records it owns the eviction; a
        raced standby or a zombie ex-leader records and kills nothing."""
        from mlcomp_tpu_torch.server.scheduler import task_priority_of
        epoch = getattr(self.session, 'fence_epoch', None)
        recorded = self.preemption_provider.record(
            victim, initiator, reason, cores_freed, epoch,
            victim_class=task_priority_of(victim),
            initiator_class=task_priority_of(initiator))
        if not recorded:
            return False
        # the chaos seam between decision and apply: a leader dying HERE
        # leaves the unapplied row the repair finishes
        fault_point('supervisor.preempt', task=victim.id,
                    initiator=initiator.id)
        self._apply_preemption(victim, reason)
        self._log_warning(
            f'preempted task {victim.id} ({victim.name}, class '
            f'{task_priority_of(victim)}) for task {initiator.id} '
            f'({initiator.name}, class {task_priority_of(initiator)}): '
            f'{reason}', victim.id)
        return True

    def _apply_preemption(self, victim: Task, reason: str,
                          repair: bool = False):
        """Checkpoint-stop one victim: a gang parent's ranks aborted, the
        row Failed ``preempted`` (transient: the retry pass requeues it
        with backoff and resume), its process killed, the decision
        flipped to applied, a ``scheduler.preemption`` metric row
        written at once (the exporter and the dashboard see the eviction
        now, not at the recorder's next flush) and
        ``supervisor.preemptions`` counted. Each step is idempotent, so a
        repair after a crash mid-apply converges."""
        from mlcomp_tpu_torch.server.scheduler import task_priority_of
        from mlcomp_tpu_torch.worker.tasks import kill_task
        if victim.gang_id and victim.parent is None:
            self.gang_abort(victim.id)
        if int(victim.status) != int(TaskStatus.Failed):
            self.provider.fail_with_reason(victim, 'preempted')
        try:
            kill_task(victim.id, session=self.session)
        except FenceLostError:
            raise
        except Exception:
            self._log_error(f'kill of preempted task {victim.id} '
                            f'failed:\n{traceback.format_exc()}')
        self.preemption_provider.mark_applied(
            victim.id, victim.attempt or 0)
        try:
            MetricProvider(self.session).add_many([(
                victim.id, 'scheduler.preemption', 'counter',
                victim.attempt or 0, 1.0, now(), 'supervisor',
                json.dumps({'class': task_priority_of(victim),
                            'reason': reason,
                            'repair': int(bool(repair))}))])
        except Exception:
            pass            # observability must not block the eviction
        self.telemetry.count('supervisor.preemptions')
        self.aux.setdefault('preempted', []).append(
            {'task': victim.id, 'attempt': victim.attempt or 0,
             'class': task_priority_of(victim), 'reason': reason,
             'repair': bool(repair)})

    # ---------------------------------------------------------------- usage
    def process_usage(self):
        """Fold every terminal task attempt without a ledger row into
        ``usage``: one row per (task, attempt), exactly once however many
        leaders race (``UsageProvider.fold_task``). Runs after placement
        and preemption, so an attempt that went terminal this tick (a
        victim) is billed before the next tick's retry resets its row. A
        crash here never takes the tick down. The fold's wall goes into
        ``supervisor.usage_fold_ms``, its rows into
        ``supervisor.usage_folds``."""
        t0 = time.monotonic()
        folded = 0
        try:
            while True:
                batch = self.usage_provider.unfolded_terminal_tasks(
                    limit=500)
                if not batch:
                    break
                for task in batch:
                    if self.usage_provider.fold_task(task):
                        folded += 1
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'usage fold failed:\n'
                            f'{traceback.format_exc()}')
        self.telemetry.gauge('supervisor.usage_fold_ms',
                             round((time.monotonic() - t0) * 1e3, 3))
        if folded:
            self.telemetry.count('supervisor.usage_folds', folded)
            self.aux['usage_folded'] = folded

    # ------------------------------------------------------------ watchdog
    def run_watchdog(self):
        """Evaluate the health rules (rate-limited inside the watchdog)
        and act on the stall findings: a stalled task is failed
        ``stall-killed`` (transient: the retry pass requeues it from its
        last checkpoint) and killed, its alert row the paper trail; a
        ``gang-stall`` goes to ``_act_on_gang_stall``. A crashing
        evaluation is logged and contained; a fence loss in an action
        demotes this leader.

        The order of the two writes is the preemption engine's, not the
        JAX tick's (kill, then fail): the Failed verdict lands before the
        SIGTERM. A ``run-task`` process turns SIGTERM into
        ``SystemExit(143)`` and writes no status on its way out, but the
        worker's post-exit verdict (``classify_returncode(143)``,
        ``preempted``) is written while the row still reads Queued or
        InProgress with its claim; after a kill first, a supervisor
        delayed between the signal and its own writes could see that
        verdict land in between and overwrite it. Failed first, the
        worker's guard never passes, so the task ends ``stall-killed``
        whichever process exits first. The rows are the JAX tick's:
        ``kill_task`` never downgrades a Failed row, so the Stopped step
        of JAX's order leaves no trace in the final row.

        Which process stops: ``kill_task`` signals a Failed row's pid
        only when that process carries the task's ``MLCOMP_TASK_ID``
        marker, i.e. a ``run-task`` process (the worker's default mode).
        Under ``worker N --in-process`` the row holds the daemon's own
        pid, which is never signalled: the task is failed and retried,
        but a run hung inside one epoch never reaches the epoch-boundary
        check that stops an in-process trainer whose row went terminal,
        and keeps the daemon until it returns. The JAX package's
        in-process worker has the same limit."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        try:
            findings = self.watchdog.maybe_evaluate()
        except Exception:
            self._log_error(f'watchdog evaluation failed:\n'
                            f'{traceback.format_exc()}')
            return
        if not findings:
            return
        self.aux['watchdog'] = [
            {k: f.get(k) for k in ('rule', 'task', 'severity', 'message')}
            for f in findings]
        for finding in findings:
            if finding['rule'] == 'gang-stall':
                self._act_on_gang_stall(finding)
                continue
            if finding['rule'] != 'task-stall':
                continue
            task_id = finding['task']
            try:
                task = self.provider.by_id(task_id)
                if task is not None and \
                        task.status != int(TaskStatus.Failed):
                    self.provider.fail_with_reason(task, 'stall-killed')
                kill_task(task_id, session=self.session)
                self._log_error(
                    f'watchdog: {finding["message"]} — task marked '
                    f'Failed (alert {finding.get("alert_id")})', task_id)
            except FenceLostError:
                raise       # zombie leader: stop the tick, demote
            except Exception:
                self._log_error(f'watchdog failed stopping stalled task '
                                f'{task_id}:\n{traceback.format_exc()}')

    def _act_on_gang_stall(self, finding):
        """A gang rank's host went silent: fail the silent rank
        (``worker-lost``, the root cause the gang verdict retries on),
        kill it and gang-abort its siblings in this tick, so the
        survivors stop burning their slots at a dead collective."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        task_id = finding['task']
        try:
            task = self.provider.by_id(task_id)
            if task is None or task.status >= int(TaskStatus.Failed):
                return          # raced: someone else already acted
            self.provider.fail_with_reason(task, 'worker-lost')
            kill_task(task_id, session=self.session)
            parent = self.provider.by_id(task.parent) \
                if task.parent else None
            if parent is not None and \
                    parent.status < int(TaskStatus.Failed):
                self._fail_gang_parent(parent)
            self._log_error(
                f'watchdog: {finding["message"]} — rank failed '
                f'worker-lost, gang aborted (alert '
                f'{finding.get("alert_id")})', task_id)
        except FenceLostError:
            raise           # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'watchdog failed acting on gang-stall for '
                            f'task {task_id}:\n{traceback.format_exc()}')

    def run_slo(self):
        """Evaluate the SLO burn-rate engine (rate-limited inside the
        engine): breached objectives raise deduped ``slo-*`` alerts,
        recovered ones auto-resolve. The pass's wall goes into
        ``supervisor.slo_eval_ms``. A crash is logged and contained; a
        fence loss demotes this leader."""
        t0 = time.monotonic()
        try:
            findings = self.slo_engine.maybe_evaluate()
        except FenceLostError:
            raise       # zombie leader: stop the tick, demote
        except Exception:
            self._log_error(f'slo evaluation failed:\n'
                            f'{traceback.format_exc()}')
            findings = None
        self.telemetry.gauge('supervisor.slo_eval_ms',
                             round((time.monotonic() - t0) * 1e3, 3))
        if findings:
            self.aux['slo'] = [
                {k: f.get(k) for k in ('rule', 'severity', 'burn',
                                       'message')}
                for f in findings]

    # ------------------------------------------------------------- trace
    def write_auxiliary(self):
        """Persist the tick's decision trace."""
        self.auxiliary_provider.create_or_update('supervisor', self.aux)

    def record_tick_telemetry(self):
        """The tick's gauges into the recorder, then the dispatch spans
        flushed: ``supervisor.tick_ms``; the deltas since the last tick
        of the store's busy retries, the event listener's reconnects and
        the writes the epoch fence rejected; the lease epoch, the tick's
        dispatches and unplaced tasks; and, for every queue message
        claimed since the last tick, its enqueue→claim wait into
        ``supervisor.dispatch_latency_s`` and into
        ``queue.wait_s.<class>.<priority>`` (the exporter splits the
        priority back out as a label)."""
        from mlcomp_tpu_torch.server.scheduler import (
            task_class_of, task_priority_of,
        )
        tel = self.telemetry
        if self.aux.get('duration') is not None:
            tel.gauge('supervisor.tick_ms', self.aux['duration'] * 1e3)
        stats = busy_retry_stats()
        for kind, series in (('retries', 'db.busy_retries'),
                             ('gave_up', 'db.busy_gave_up')):
            delta = stats[kind] - self._busy_seen.get(kind, 0)
            if delta > 0:
                tel.count(series, delta)
        self._busy_seen = stats
        lstats = listener_stats()
        delta = lstats['reconnects'] - \
            self._listener_seen.get('reconnects', 0)
        if delta > 0:
            tel.count('db.listener_reconnects', delta)
        self._listener_seen = lstats
        # rejected zombie writes are rare, and each is a failover story
        rejections = fence_rejections()
        delta = rejections - self._fence_seen
        if delta > 0:
            tel.count('supervisor.fenced_writes', delta)
        self._fence_seen = rejections
        if self.lease is not None:
            tel.gauge('supervisor.epoch', float(self.lease.epoch or 0))
        dispatched = self.aux.get('dispatched')
        if dispatched:
            tel.count('supervisor.dispatched', len(dispatched))
        if self.aux.get('not_placed'):
            tel.gauge('supervisor.not_placed', len(self.aux['not_placed']))
        try:
            # a message whose task is gone classifies as 'train'
            rows = self.session.query(
                'SELECT qm.created, qm.claimed_at, t.executor, '
                't.type, t.additional_info, t.priority '
                'FROM queue_message qm '
                'LEFT JOIN task t ON t.queue_id = qm.id '
                'WHERE qm.claimed_at IS NOT NULL AND qm.claimed_at > ?',
                (self._last_claim_ts,))
        except Exception:
            rows = []
        latest = None
        for r in rows:
            created = parse_datetime(r['created'])
            claimed = parse_datetime(r['claimed_at'])
            if created and claimed:
                wait = (claimed - created).total_seconds()
                tel.observe('supervisor.dispatch_latency_s', wait)
                row = {'executor': r['executor'], 'type': r['type'],
                       'additional_info': r['additional_info'],
                       'priority': r['priority']}
                tel.observe(
                    f'queue.wait_s.{task_class_of(row)}.'
                    f'{task_priority_of(row)}',
                    wait, buckets=QUEUE_WAIT_BUCKETS_S)
            if claimed and (latest is None or claimed > latest):
                latest = claimed
        if latest is not None:
            self._last_claim_ts = latest
        self._record_starvation_gauges(tel)
        flush_spans(self.session)

    def _record_starvation_gauges(self, tel):
        """``queue.max_wait_s.<class>``: the oldest pending dispatch of
        each class, over the live queue every tick (the claim-time
        histograms see only waits that ended). A class with an empty
        queue gauges 0."""
        from mlcomp_tpu_torch.server.scheduler import (
            TASK_CLASSES, task_class_of,
        )
        try:
            rows = self.session.query(
                "SELECT qm.created, t.executor, t.type, "
                "t.additional_info FROM queue_message qm "
                "LEFT JOIN task t ON t.queue_id = qm.id "
                "WHERE qm.status='pending'")
        except Exception:
            return
        now_dt = now()
        max_wait = {cls: 0.0 for cls in TASK_CLASSES}
        for r in rows:
            created = parse_datetime(r['created'])
            if created is None:
                continue
            wait = (now_dt - created).total_seconds()
            cls = task_class_of({'executor': r['executor'],
                                 'type': r['type'],
                                 'additional_info': r['additional_info']})
            if wait > max_wait.get(cls, 0.0):
                max_wait[cls] = wait
        for cls, wait in max_wait.items():
            tel.gauge(f'queue.max_wait_s.{cls}', round(wait, 3))

    # ---------------------------------------------------------------- main
    def build(self):
        """One tick. A failing tick heals by rebuilding the builder on a
        fresh session; a refusal (``NotImplementedError``) and a fenced
        write (``FenceLostError``: a newer leader exists) propagate."""
        start = now()
        try:
            self.refuse_unported()
            self.create_base()
            self.process_parent_tasks()
            # recovery before load_tasks: a task requeued this tick
            # re-loads as NotRan and can re-dispatch at once
            self.process_recovery()
            # sweeps before load_tasks for the same reason: a cell
            # pruned this tick frees its cores for the placement below
            self.process_sweeps()
            self.process_fleets()
            self.load_tasks()
            self.load_computers()
            self.process_tasks()
            # preemption after placement: it works off the tasks that
            # placement could not fit; its frees re-place next tick
            self.process_preemptions()
            # usage after both, so attempts that went terminal this tick
            # are folded in it
            self.process_usage()
            self.run_watchdog()
            self.run_slo()
            self.aux['duration'] = (now() - start).total_seconds()
            self.write_auxiliary()
            self.record_tick_telemetry()
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
                          fleet_config=self.fleet_config,
                          fleet_probe=self.fleet_probe, lease=lease)


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
                        lease_seconds: float = None, fleet_config=None,
                        fleet_probe=None):
    """Start the supervisor loop on a background thread; returns
    ``(builder, [loop])`` (``loop.stop()`` ends it). With ``ha=True``
    (the default) the loop contends for the ``supervisor_lease`` leader
    election (server/ha.py): alone it acquires at once, and any further
    supervisor becomes a hot standby; every control-state write is
    epoch-fenced (db/fencing.py). ``ha=False`` runs a lease-less
    loop. ``fleet_config`` (``server/fleet.py`` ``FleetConfig``) and
    ``fleet_probe`` reach the ``SupervisorBuilder``'s fleet reconciler."""
    session = session or Session.create_session(key='supervisor')
    lease = None
    if ha:
        from mlcomp_tpu_torch.server.ha import (
            DEFAULT_LEASE_SECONDS, LeaderLease,
        )
        lease = LeaderLease(
            session, lease_seconds=lease_seconds or DEFAULT_LEASE_SECONDS)
    builder = SupervisorBuilder(session=session, logger=logger, lease=lease,
                                fleet_config=fleet_config,
                                fleet_probe=fleet_probe)
    loop = SupervisorLoop(builder, interval=interval, lease=lease)
    loop.start()
    return builder, [loop]


__all__ = ['SupervisorBuilder', 'SupervisorLoop', 'register_supervisor',
           'QUEUE_WAIT_BUCKETS_S']

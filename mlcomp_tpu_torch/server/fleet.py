"""Fleet reconciler — the supervisor's serving half (port of
``mlcomp_tpu/server/fleet.py``).

A fleet (db/models/fleet.py) declares DESIRED serving state: N
replicas of one model export behind the routing gateway
(server/gateway.py). This module is the control loop that drives
ACTUAL toward it, one supervisor tick at a time, with the recovery
machinery the training tasks use:

- **desired-count reconciliation** — each live replica is a
  supervisor-scheduled Service task (``serve_replica`` executor); a
  shortfall mints replica rows + task rows that the NORMAL placement
  path (``process_tasks``) dispatches, including ``retry_exclude`` of
  the computer that just failed a replica.
- **health classification** — replicas are probed (``GET /health``)
  and their tasks watched: a probe-failing replica is classified
  ``replica-unhealthy`` (transient, recovery taxonomy), its task
  killed through ``kill_task`` (revoke + SIGTERM, local or routed),
  and a replacement spawned on another computer EXACTLY ONCE —
  ``respawned_from`` records the lineage, ``already_respawned`` guards
  the once. Heartbeat-silent replicas (task ``last_activity`` past the
  silence horizon) go the same way as ``worker-lost``; a replica whose
  task died through the lease/worker machinery inherits that task's
  taxonomy verdict.
- **rolling model swap** — ``start_swap`` stages generation N+1 with a
  new export; the reconciler brings its replicas up and WARM (healthy
  probes — the replica executor runs the predictor once before it
  binds), then flips the fleet's active generation (the gateway's
  refresh re-routes), marks generation N draining, and retires it
  after a grace period through ``serve.py``'s graceful drain. A warmup
  that misses its deadline rolls back: generation N+1 is retired, the
  active generation never flips, and a critical ``swap-rollback`` alert
  says so.

Every transition is observable: ``fleet.respawn`` / ``fleet.swap``
metric events feed ``mlcomp_fleet_respawns_total`` /
``mlcomp_fleet_swaps_total`` on the API server's /metrics, replica
states and generations are exported as gauges, and the dashboard's
fleet card renders the roster. The rows are the JAX package's: either
package's reconciler, gateway and readers work on the same DB.

The port adds one option: ``create_fleet(activation=...)`` (``softmax``,
``sigmoid`` or ``argmax``) writes the fleet's internal dag with that
activation in the ``serve_replica`` executor's options, so a fleet of a
language model can answer token ids instead of every position's logits.
Without it the dag is the JAX package's, created at the first spawn.
And where JAX mints a replica task with ``fleet.cores or 1`` card slots,
the port takes ``cores`` as it is: a fleet of ``cores=0`` places its
replicas with no slot (``cores_assigned`` ``[]``), so they share the
cards of their host; NULL still reads as 1. Last, a tick that read a
fleet active just before ``stop_fleet`` landed can respawn a replica the
stop had just retired; JAX's reconciler never visits a stopped fleet
again, so that replica lives on. The port's tick ends by retiring what
is still live in a stopped fleet (``_retire_stopped``), as the stop
retires it.
"""

import json
import traceback

from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus, TaskType
from mlcomp_tpu_torch.db.models import Dag, ServeFleet, ServeReplica, Task
from mlcomp_tpu_torch.db.providers import (
    DagProvider, FleetProvider, ReplicaProvider, TaskProvider,
)
from mlcomp_tpu_torch.db.providers.fleet import LIVE_STATES
from mlcomp_tpu_torch.utils.io import yaml_dump
from mlcomp_tpu_torch.utils.misc import now

#: what ``create_fleet(activation=)`` accepts (``make_predictor``'s)
ACTIVATIONS = (None, 'softmax', 'sigmoid', 'argmax')


class FleetConfig:
    """Reconciler knobs; keyword overrides like RecoveryConfig."""

    #: seconds between health probes of one replica
    probe_interval_s = 5.0
    #: HTTP timeout of one probe
    probe_timeout_s = 2.0
    #: consecutive probe failures before a healthy replica is declared
    #: unhealthy and replaced
    unhealthy_after = 3
    #: task last_activity silence (s) past which a replica with no
    #: reachable endpoint is declared worker-lost. The replica
    #: executor's beat touches last_activity every few seconds, so this
    #: horizon only needs to cover a slow export load + XLA compile.
    replica_silence_s = 180.0
    #: seconds a swap's generation N+1 may take to come up healthy
    #: before the swap rolls back
    warmup_timeout_s = 300.0
    #: seconds a draining (post-flip) replica keeps serving before its
    #: task is retired — covers the gateway's refresh interval plus
    #: in-flight requests
    drain_grace_s = 10.0

    def __init__(self, **overrides):
        for key, value in overrides.items():
            if not hasattr(type(self), key):
                raise TypeError(f'unknown fleet option {key!r}')
            setattr(self, key, type(getattr(type(self), key))(value))


def http_probe(url: str, timeout_s: float = 2.0) -> bool:
    """Default health probe: ``GET <url>/health`` must answer 200 with
    ``status: ok`` — a draining replica is alive but must leave the
    routable set. Marked with the probe header so admission control
    never sheds it."""
    import urllib.request
    from mlcomp_tpu_torch.server.gateway import PROBE_HEADER
    req = urllib.request.Request(url.rstrip('/') + '/health',
                                 headers={PROBE_HEADER: '1'})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            if resp.status != 200:
                return False
            body = json.loads(resp.read())
            return body.get('status') == 'ok'
    except Exception:
        return False


def create_fleet(session, name: str, model: str, project: str = None,
                 desired: int = 2, slo_p99_ms: float = 250.0,
                 cores: int = 1, batch_size: int = 64,
                 quantize: str = None, max_pending: int = 256,
                 priority: str = None, activation: str = None):
    """Register a fleet (idempotent on name). The reconciler brings the
    replicas up on the next supervisor tick. ``priority`` is the v15
    scheduling class its replicas dispatch under (validated; NULL
    reads as the serve-replica default, ``high``). ``activation``
    (``softmax``, ``sigmoid``, ``argmax``) is applied by every replica
    to the model's output; it lives in the fleet's dag (module
    docstring)."""
    from mlcomp_tpu_torch.server.scheduler import normalize_priority
    if activation not in ACTIVATIONS:
        raise ValueError(f'activation must be one of {ACTIVATIONS}, '
                         f'got {activation!r}')
    provider = FleetProvider(session)
    fleet = provider.by_name(name)
    if fleet is not None:
        raise ValueError(f'fleet {name!r} already exists (id {fleet.id})')
    fleet = ServeFleet(
        name=name, project=project, model=model, desired=int(desired),
        generation=1, status='active', slo_p99_ms=float(slo_p99_ms),
        cores=int(cores), batch_size=int(batch_size), quantize=quantize,
        max_pending=int(max_pending),
        priority=normalize_priority(priority),
        created=now(), updated=now())
    provider.add(fleet)
    if activation is not None:
        fleet_dag(session, fleet, serve={'activation': activation})
    return fleet


def fleet_dag(session, fleet, serve: dict = None) -> int:
    """The fleet's internal dag row (``fleet_<name>``), created once: it
    gives replica tasks a config the worker pipeline builds the
    ``serve_replica`` executor from (no code snapshot — the executor is
    a framework builtin, which the preflight gate resolves by AST).
    ``serve`` becomes the executor's options, merged into each
    replica's ``additional_info['serve']``."""
    name = f'fleet_{fleet.name}'
    row = session.query_one('SELECT id FROM dag WHERE name=?', (name,))
    if row is not None:
        return row['id']
    spec = {'type': 'serve_replica'}
    if serve:
        spec['serve'] = dict(serve)
    dag = Dag(name=name, created=now(), config=yaml_dump({
        'info': {'name': name, 'project': fleet.project or 'default'},
        'executors': {'serve_replica': spec},
    }))
    DagProvider(session).add(dag)
    return dag.id


def start_swap(session, fleet, new_model: str):
    """Stage a rolling swap to ``new_model`` as generation N+1. The
    reconciler warms the new generation and flips the router; a failed
    warmup auto-rolls-back.

    The active→swapping transition is a CONDITIONAL update: the old
    read-check-write shape (``if fleet.status == 'swapping': raise``
    on a previously read row, then an unconditional write) let two
    concurrent swap requests both pass the check and stage clashing
    target generations — the rowcount decides exactly one winner, the
    loser gets the same ValueError the stale-read check used to give."""
    stale_generation = int(fleet.generation or 1)
    target_generation = stale_generation + 1
    started = now()
    # the WHERE also pins the GENERATION the caller read: status alone
    # is not enough — after an intervening COMPLETED swap the fleet is
    # 'active' again with generation+1, and a stale caller's
    # target_generation would collide with the live generation
    cur = session.execute(
        "UPDATE serve_fleet SET target_generation=?, target_model=?, "
        "swap_started=?, status='swapping', updated=? "
        "WHERE id=? AND status='active' AND COALESCE(generation, 1)=?",
        (target_generation, new_model, started, started, fleet.id,
         stale_generation))
    if cur.rowcount == 0:
        row = FleetProvider(session).by_id(fleet.id)
        if row is None:
            raise ValueError(f'fleet {fleet.name!r} is missing — '
                             f'cannot stage a swap')
        if row.status == 'swapping':
            raise ValueError(
                f'fleet {fleet.name!r} is swapping, not active — '
                f'already swapping to generation '
                f'{row.target_generation}')
        if row.status == 'active':
            raise ValueError(
                f'fleet {fleet.name!r} moved to generation '
                f'{row.generation} since it was read (was '
                f'{stale_generation}) — re-read the fleet and retry')
        raise ValueError(f'fleet {fleet.name!r} is {row.status}, '
                         f'not active — cannot stage a swap')
    # the caller's object reflects the row only once the write WON —
    # a losing staler must keep its (stale but self-consistent) view
    fleet.target_generation = target_generation
    fleet.target_model = new_model
    fleet.swap_started = started
    fleet.status = 'swapping'
    fleet.updated = started
    return fleet


def stop_fleet(session, fleet):
    """Retire a fleet: mark it stopped and kill every live replica
    task (graceful — the replica process drains in-flight requests on
    SIGTERM)."""
    from mlcomp_tpu_torch.worker.tasks import kill_task
    provider = FleetProvider(session)
    rp = ReplicaProvider(session)
    for replica in rp.live(fleet.id) + rp.of_fleet(
            fleet.id, states=('draining',)):
        if replica.task:
            kill_task(replica.task, session=session)
        rp.set_state(replica, 'dead', reason='fleet-stopped')
    # stopping dominates every concurrent transition: a reconciler or
    # swap write that lands after this one is corrected next tick
    # (active() excludes stopped fleets), so last-write-wins is intent
    # preflight: disable=db-naked-transition — see above
    fleet.status = 'stopped'
    provider.touch(fleet, ['status'])
    return fleet


class FleetReconciler:
    """Drives every active fleet one tick at a time. Constructed by the
    supervisor (one per SupervisorBuilder); ``probe`` is injectable so
    tests and the chaos suite control health verdicts without HTTP."""

    def __init__(self, session, logger=None, config: FleetConfig = None,
                 probe=None, telemetry=None):
        self.session = session
        self.logger = logger
        self.config = config or FleetConfig()
        self.probe = probe or (
            lambda url: http_probe(url, self.config.probe_timeout_s))
        self.telemetry = telemetry
        self.fleets = FleetProvider(session)
        self.replicas = ReplicaProvider(session)
        self.tasks = TaskProvider(session)
        self.aux = {}

    # ------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One reconciliation pass over every active fleet. Crashes are
        contained per fleet — the serving control loop must never take
        the scheduling tick down."""
        self.aux = {}
        from mlcomp_tpu_torch.db.fencing import FenceLostError
        self._retire_stopped()
        for fleet in self.fleets.active():
            try:
                self._reconcile(fleet)
            except FenceLostError:
                # not a sick fleet — a NEWER SUPERVISOR LEADER exists
                # and the store rejected this zombie's write: stop the
                # whole tick so the HA loop demotes (db/fencing.py)
                raise
            except Exception:
                if self.logger:
                    self.logger.error(
                        f'fleet {fleet.name} reconcile failed:\n'
                        f'{traceback.format_exc()}',
                        ComponentType.Supervisor)
        return self.aux

    def _retire_stopped(self):
        """Stop again every stopped fleet that still has a live or
        draining replica: one a tick spawned while ``stop_fleet`` ran."""
        states = LIVE_STATES + ('draining',)
        for row in self.session.query(
                "SELECT * FROM serve_fleet WHERE status = 'stopped' AND id "
                "IN (SELECT fleet FROM serve_replica WHERE state IN "
                f"({','.join('?' * len(states))}))", states):
            stop_fleet(self.session, ServeFleet.from_row(row))

    def _reconcile(self, fleet):
        self._absorb_task_verdicts(fleet)
        self._probe_replicas(fleet)
        self._retire_draining(fleet)
        if fleet.status == 'swapping':
            self._advance_swap(fleet)
        generations = [(fleet.generation, fleet.model)]
        if fleet.status == 'swapping' and fleet.target_generation:
            generations.append((fleet.target_generation,
                                fleet.target_model or fleet.model))
        for generation, model in generations:
            self._ensure_desired(fleet, generation, model)

    # ----------------------------------------------------- health gates
    def _absorb_task_verdicts(self, fleet):
        """A replica whose TASK reached a terminal state is dead — the
        lease/watchdog/taxonomy machinery already judged it; the
        replica row inherits the verdict and the shortfall respawns it
        elsewhere (``retry_exclude`` carries the blame)."""
        for replica in self.replicas.live(fleet.id):
            task = self.tasks.by_id(replica.task) if replica.task else None
            if task is None:
                self.replicas.set_state(replica, 'dead',
                                        reason='task-missing')
                continue
            if task.status == int(TaskStatus.Failed):
                self.replicas.set_state(
                    replica, 'dead',
                    reason=task.failure_reason or 'worker-lost')
                self._note(fleet, 'replica_dead', replica.id,
                           task.failure_reason or 'worker-lost')
            elif task.status in (int(TaskStatus.Stopped),
                                 int(TaskStatus.Skipped),
                                 int(TaskStatus.Success)):
                # a serving task never finishes on its own: Stopped =
                # operator/swap retirement, Success = clean drain exit
                self.replicas.set_state(replica, 'dead',
                                        reason='stopped')
            elif task.status == int(TaskStatus.InProgress):
                self._check_silence(fleet, replica, task)

    def _check_silence(self, fleet, replica, task):
        from mlcomp_tpu_torch.db.core import parse_datetime
        last = parse_datetime(task.last_activity)
        if last is None:
            return
        silence = (now() - last).total_seconds()
        if silence <= float(self.config.replica_silence_s):
            return
        # heartbeat-silent replica: same verdict the gang-stall rule
        # gives a silent rank — worker-lost, kill, respawn elsewhere
        self._fail_replica(fleet, replica, task, 'worker-lost',
                           f'heartbeat silent {silence:.0f}s')

    def _probe_replicas(self, fleet):
        from mlcomp_tpu_torch.db.core import parse_datetime
        due = []
        for replica in self.replicas.live(fleet.id):
            if not replica.url:
                continue        # endpoint not bound yet: silence guard
            last = parse_datetime(replica.last_probe)
            if last is not None and (now() - last).total_seconds() < \
                    float(self.config.probe_interval_s):
                continue
            due.append(replica)
        if not due:
            return
        # probes run CONCURRENTLY: this loop lives inside the 1 Hz
        # supervisor tick, and a dead host's probes each block the
        # full probe_timeout_s — serially, M unreachable replicas
        # would freeze lease reclaim/watchdog/placement for 2*M s
        # exactly when a failure is in progress. One timeout bounds
        # the whole batch instead.
        def run_probe(replica):
            try:
                return bool(self.probe(replica.url))
            except Exception:
                return False
        if len(due) == 1:
            verdicts = [run_probe(due[0])]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(8, len(due))) \
                    as pool:
                verdicts = list(pool.map(run_probe, due))
        for replica, ok in zip(due, verdicts):
            flipped = self.replicas.record_probe(
                replica, ok,
                unhealthy_after=int(self.config.unhealthy_after))
            if flipped or (not ok and replica.state == 'unhealthy'
                           and replica.probe_failures >=
                           2 * int(self.config.unhealthy_after)):
                task = self.tasks.by_id(replica.task) \
                    if replica.task else None
                self._fail_replica(
                    fleet, replica, task, 'replica-unhealthy',
                    f'{replica.probe_failures} consecutive probe '
                    f'failures')

    def _fail_replica(self, fleet, replica, task, reason: str,
                      detail: str):
        """Classify → kill → mark dead. The respawn happens in the
        SAME tick's desired-count pass, excluding this computer."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        if task is not None and task.status < int(TaskStatus.Failed):
            self.tasks.fail_with_reason(task, reason)
        if replica.task:
            try:
                kill_task(replica.task, session=self.session)
            except Exception:
                pass            # routed kill is best-effort; the row
        self.replicas.set_state(replica, 'dead', reason=reason)
        self._note(fleet, 'replica_dead', replica.id,
                   f'{reason} ({detail})')
        if self.logger:
            self.logger.warning(
                f'fleet {fleet.name}: replica {replica.id} on '
                f'{replica.computer or "?"} failed {reason} ({detail}) '
                f'— killing and respawning elsewhere',
                ComponentType.Supervisor, None, replica.task)

    # ------------------------------------------------------ desired count
    def _ensure_desired(self, fleet, generation: int, model: str):
        live = self.replicas.live(fleet.id, generation)
        need = int(fleet.desired or 0) - len(live)
        if need <= 0:
            return
        # respawn lineage first: each dead-but-never-respawned replica
        # of this generation seeds ONE replacement, excluding its
        # computer — the exactly-once contract the chaos suite asserts
        dead = [r for r in self.replicas.of_fleet(
                    fleet.id, generation, states=('dead',))
                if not self.replicas.already_respawned(r.id)]
        spawned = []
        for corpse in dead[:need]:
            exclude = [corpse.computer] if corpse.computer else None
            replica = self._spawn(fleet, generation, model,
                                  exclude=exclude,
                                  respawned_from=corpse.id,
                                  reason=corpse.failure_reason)
            spawned.append(replica.id)
        for _ in range(need - len(spawned)):
            replica = self._spawn(fleet, generation, model)
            spawned.append(replica.id)
        if spawned:
            self.aux.setdefault('spawned', {}).setdefault(
                fleet.name, []).extend(spawned)

    def _spawn(self, fleet, generation: int, model: str, exclude=None,
               respawned_from=None, reason=None) -> ServeReplica:
        replica = ServeReplica(
            fleet=fleet.id, generation=int(generation),
            state='starting', respawned_from=respawned_from,
            created=now(), updated=now())
        self.replicas.add(replica)
        info = {'serve': {
            'fleet': fleet.id, 'fleet_name': fleet.name,
            'replica': replica.id, 'generation': int(generation),
            'model': model, 'project': fleet.project,
            'batch_size': int(fleet.batch_size or 64),
            'quantize': fleet.quantize,
            'max_pending': int(fleet.max_pending or 256),
        }}
        if exclude:
            info['retry_exclude'] = sorted(
                c for c in exclude if c)
        # a fleet of cores 0 asks for no card slot (its replicas share
        # the cards the host shows); JAX's ``fleet.cores or 1`` reads 0
        # as 1, so there such a fleet cannot be declared
        cores = 1 if fleet.cores is None else int(fleet.cores)
        task = Task(
            name=f'serve_{fleet.name}_g{generation}_r{replica.id}',
            status=int(TaskStatus.NotRan),
            executor='serve_replica',
            cores=cores, cores_max=cores,
            cpu=1, memory=0.1,
            dag=fleet_dag(self.session, fleet),
            type=int(TaskType.Service), single_node=1,
            additional_info=yaml_dump(info),
            # replicas dispatch under the fleet's scheduling class;
            # NULL keeps the serve-replica default ('high')
            priority=fleet.priority,
            project=fleet.project,
            last_activity=now())
        self.tasks.add(task)
        replica.task = task.id
        self.replicas.update(replica, ['task'])
        if respawned_from is not None:
            self._event(fleet, 'fleet.respawn',
                        {'fleet': fleet.name,
                         'reason': reason or 'unknown'},
                        value=replica.id, task=task.id)
            if self.telemetry is not None:
                self.telemetry.count('supervisor.fleet_respawns')
        return replica

    # ------------------------------------------------------------- swap
    def _advance_swap(self, fleet):
        from mlcomp_tpu_torch.db.core import parse_datetime
        target = fleet.target_generation
        if not target:          # inconsistent row: heal to active
            # reconciler transitions run on the one supervisor tick
            # thread — the swap state machine has a single writer
            # preflight: disable=db-naked-transition — see above
            fleet.status = 'active'
            self.fleets.touch(fleet, ['status'])
            return
        live = self.replicas.live(fleet.id, target)
        healthy = [r for r in live if r.state == 'healthy']
        if len(healthy) >= int(fleet.desired or 0) and fleet.desired:
            self._flip(fleet)
            return
        started = parse_datetime(fleet.swap_started)
        if started is not None and \
                (now() - started).total_seconds() > \
                float(self.config.warmup_timeout_s):
            self._rollback(fleet)

    def _flip(self, fleet):
        """Generation N+1 is warm: route to it, drain N. The flip is
        one row update — the gateway's next refresh re-reads the
        active generation and swaps its backend set wholesale."""
        old_generation = fleet.generation
        # single-writer: the flip runs on the one supervisor tick
        # thread, and the only concurrent generation writer —
        # start_swap — requires status='active', which is false for
        # the whole 'swapping' window this flip closes
        # preflight: disable=db-naked-transition — see above
        fleet.generation = fleet.target_generation
        fleet.model = fleet.target_model or fleet.model
        fleet.target_generation = None
        fleet.target_model = None
        fleet.swap_started = None
        # single-writer: only the reconciler (supervisor tick) flips —
        # start_swap's conditional UPDATE is the concurrent entry point
        # and it requires status='active', losing cleanly mid-swap
        # preflight: disable=db-naked-transition — see above
        fleet.status = 'active'
        self.fleets.touch(fleet, ['generation', 'model',
                                  'target_generation', 'target_model',
                                  'swap_started', 'status'])
        for replica in self.replicas.live(fleet.id, old_generation):
            self.replicas.set_state(replica, 'draining')
        self._event(fleet, 'fleet.swap',
                    {'fleet': fleet.name, 'outcome': 'completed'},
                    value=fleet.generation)
        self._note(fleet, 'swap', 'completed',
                   f'generation {fleet.generation}')
        if self.logger:
            self.logger.info(
                f'fleet {fleet.name}: rolling swap complete — '
                f'generation {fleet.generation} ({fleet.model}) is '
                f'live, generation {old_generation} draining',
                ComponentType.Supervisor)

    def _rollback(self, fleet):
        """Warmup missed its deadline: retire generation N+1, keep
        serving N, and say so loudly."""
        from mlcomp_tpu_torch.worker.tasks import kill_task
        target = fleet.target_generation
        for replica in self.replicas.live(fleet.id, target):
            if replica.task:
                try:
                    kill_task(replica.task, session=self.session)
                except Exception:
                    pass
            self.replicas.set_state(replica, 'dead',
                                    reason='swap-rollback')
        fleet.target_generation = None
        fleet.target_model = None
        fleet.swap_started = None
        # single-writer reconciler rollback, same argument as _flip
        # preflight: disable=db-naked-transition — see above
        fleet.status = 'active'
        self.fleets.touch(fleet, ['target_generation', 'target_model',
                                  'swap_started', 'status'])
        self._event(fleet, 'fleet.swap',
                    {'fleet': fleet.name, 'outcome': 'rollback'},
                    value=target)
        self._note(fleet, 'swap', 'rollback',
                   f'generation {target} warmup timed out')
        try:
            from mlcomp_tpu_torch.db.providers import AlertProvider
            AlertProvider(self.session).raise_alert(
                'swap-rollback',
                f'fleet {fleet.name}: generation {target} warmup '
                f'exceeded {self.config.warmup_timeout_s:.0f}s — '
                f'rolled back to generation {fleet.generation}',
                severity='critical',
                details={'fleet': fleet.name, 'generation': target})
        except Exception:
            pass                # alerting must not block the rollback
        if self.logger:
            self.logger.error(
                f'fleet {fleet.name}: swap to generation {target} '
                f'rolled back (warmup timeout)',
                ComponentType.Supervisor)

    def _retire_draining(self, fleet):
        """Draining replicas keep serving through the drain grace (the
        gateway has already stopped routing to them), then their tasks
        are stopped — serve.py's SIGTERM path finishes what's in
        flight. A drained task reaching a terminal state marks the
        replica dead in ``_absorb_task_verdicts``' next pass."""
        from mlcomp_tpu_torch.db.core import parse_datetime
        from mlcomp_tpu_torch.worker.tasks import kill_task
        for replica in self.replicas.of_fleet(fleet.id,
                                              states=('draining',)):
            task = self.tasks.by_id(replica.task) if replica.task else None
            if task is None or task.status > int(TaskStatus.InProgress):
                self.replicas.set_state(replica, 'dead',
                                        reason='drained')
                continue
            since = parse_datetime(replica.updated)
            if since is not None and \
                    (now() - since).total_seconds() < \
                    float(self.config.drain_grace_s):
                continue
            try:
                kill_task(replica.task, session=self.session)
            except Exception:
                pass

    # ------------------------------------------------------ observability
    def _event(self, fleet, name: str, tags: dict, value=1.0,
               task=None):
        """Immediate metric event row (like the supervisor's
        task.retry/gang.generation events) — the windowed /metrics
        scans and the dashboard timeline read these."""
        from mlcomp_tpu_torch.db.providers import MetricProvider
        try:
            MetricProvider(self.session).add_many([
                (task, name, 'counter', None, float(value), now(),
                 'supervisor', json.dumps(tags))])
        except Exception:
            pass                # observability must not block the loop

    def _note(self, fleet, kind: str, *detail):
        self.aux.setdefault(kind, {}).setdefault(
            fleet.name, []).append(' '.join(str(d) for d in detail))


__all__ = ['FleetReconciler', 'FleetConfig', 'create_fleet', 'fleet_dag',
           'start_swap', 'stop_fleet', 'http_probe']

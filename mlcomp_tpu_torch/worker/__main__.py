"""Worker daemons (port of ``mlcomp_tpu/worker/__main__.py``), on
``argparse``:

- ``worker N [--in-process]`` — task consumer #N: claims execute/kill
  messages from its queues (``{host}_{docker}``, ``{host}_{docker}_{N}``)
  and runs each task in a ``run-task`` process of its own (a failed or
  killed task cannot take the daemon's state with it). ``--in-process``
  runs the task in the daemon instead, which keeps CUDA initialised
  between tasks.
- ``worker-supervisor [--cores N]`` — the host agent: registers the
  Computer and Docker rows, heartbeats, reaps tasks whose process
  vanished, writes host telemetry, drains the host's control queue and
  syncs data from other computers every 60 s.
- ``start N [--in-process]`` — spawns worker-supervisor and N workers as
  child processes and restarts them when they exit.
- ``stop``                 — SIGTERMs the daemons ``start`` spawned.
- ``run-task ID``          — internal: execute one task in this process.

The card count comes from a subprocess (``MLCOMP_TPU_CORES``
overrides it), so the host agent never creates a CUDA context that
would hold card memory for its whole life.
"""

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

from mlcomp_tpu_torch import (
    CAN_PROCESS_TASKS, DOCKER_IMG, IP, PORT, QUEUE_POLL_INTERVAL,
    ROOT_FOLDER, SYNC_WITH_THIS_COMPUTER, WORKER_USAGE_INTERVAL,
)
from mlcomp_tpu_torch.db.core import Session, busy_retry_stats, parse_datetime
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.events import queue_channel
from mlcomp_tpu_torch.db.migration import migrate
from mlcomp_tpu_torch.db.models import Computer
from mlcomp_tpu_torch.db.providers import (
    ComputerProvider, DockerProvider, MetricProvider, QueueProvider,
    TaskProvider,
)
from mlcomp_tpu_torch.telemetry.spans import PROCESS_ROLE_ENV, TRACE_ID_ENV
from mlcomp_tpu_torch.utils import procfs
from mlcomp_tpu_torch.utils.logging import create_logger
from mlcomp_tpu_torch.utils.misc import hostname, now
from mlcomp_tpu_torch.worker.tasks import TASK_ID_ENV

HOSTNAME = hostname()

#: wait horizon where the backend delivers cross-process wakeups: a
#: lost-wakeup backstop, not a latency floor
EVENT_WAIT_BACKSTOP_S = 5.0

#: ceiling of the worker loop's exponential error backoff
ERROR_BACKOFF_MAX_S = 60.0


def _card_count() -> int:
    """CUDA cards this host's task processes see: ``MLCOMP_TPU_CORES``
    when set, else ``torch.cuda.device_count()`` in a subprocess."""
    env = os.environ.get('MLCOMP_TPU_CORES')
    if env is not None:
        return int(env)
    try:
        out = subprocess.run(
            [sys.executable, '-c',
             'import torch; print(torch.cuda.device_count())'],
            capture_output=True, text=True, timeout=120)
        return int(out.stdout.strip().splitlines()[-1])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return 0


def register_computer(session, cores: int = None):
    """Register or refresh this host's Computer row."""
    computer = Computer(
        name=HOSTNAME,
        cores=cores if cores is not None else _card_count(),
        cpu=multiprocessing.cpu_count(),
        memory=procfs.memory_gb()[0],
        disk=procfs.disk_gb(ROOT_FOLDER)[0],
        ip=IP,
        port=PORT,
        user=os.environ.get('USER', 'root'),
        can_process_tasks=CAN_PROCESS_TASKS,
        sync_with_this_computer=SYNC_WITH_THIS_COMPUTER,
    )
    ComputerProvider(session).create_or_update(computer, 'name')
    return computer


def queue_names(index: int = None):
    base = f'{HOSTNAME}_{DOCKER_IMG}'
    queues = [base]
    if index is not None:
        queues.append(f'{base}_{index}')
    return queues


# --------------------------------------------------------------- consumer
def _run_subprocess(task_id: int, index: int, trace_id: str = None) -> int:
    """Execute a task in a ``run-task`` process; its exit status (0 =
    success, negative = killed by that signal)."""
    env = dict(os.environ)
    # read back from /proc/<pid>/environ by kill_task's pid-reuse guard
    env[TASK_ID_ENV] = str(task_id)
    if trace_id:
        # the child's spans join the submission's trace
        env[TRACE_ID_ENV] = str(trace_id)
        env[PROCESS_ROLE_ENV] = 'worker'
    else:
        # a previous task's trace must not label this child's spans
        env.pop(TRACE_ID_ENV, None)
        env.pop(PROCESS_ROLE_ENV, None)
    cmd = [sys.executable, '-m', 'mlcomp_tpu_torch.worker', 'run-task',
           str(task_id), '--index', str(index)]
    return subprocess.run(cmd, env=env).returncode


def _card_usage():
    """The card's memory where CUDA is already initialised in this
    process (an in-process worker); [] elsewhere, so telemetry never
    creates a context. The DB is the JAX package's, so the entry keeps
    its ``computer.usage`` shape: the key ``tpu``, fields ``id``,
    ``kind``, ``hbm_used`` (bytes the allocator holds) and
    ``hbm_limit`` (the card's memory)."""
    torch = sys.modules.get('torch')
    if torch is None or not torch.cuda.is_initialized():
        return []
    i = torch.cuda.current_device()
    _free, total = torch.cuda.mem_get_info(i)
    return [{'id': i, 'kind': torch.cuda.get_device_name(i),
             'hbm_used': torch.cuda.memory_allocated(i),
             'hbm_limit': total}]


def _consume_one(session, queue_provider, logger, index: int,
                 in_process: bool) -> bool:
    """Claim and run one message of this worker's queues; False when
    there was none."""
    me = f'{HOSTNAME}:{index}'
    claim = queue_provider.claim(queue_names(index), me)
    if claim is None:
        return False
    msg_id, payload = claim
    action = payload.get('action')
    task_id = payload.get('task_id')
    trace_id = payload.get('trace_id')
    try:
        if action == 'execute':
            if in_process:
                from mlcomp_tpu_torch.worker.tasks import execute_by_id
                execute_by_id(task_id, worker_index=index,
                              session=session, trace_id=trace_id)
                ok = True
                # this process holds the card: only it can report the
                # card's memory (worker_usage keeps this field)
                usage = _card_usage()
                if usage:
                    ComputerProvider(session).update_usage_fields(
                        HOSTNAME, {'tpu': usage})
            else:
                started = time.monotonic()
                returncode = _run_subprocess(task_id, index,
                                             trace_id=trace_id)
                ok = returncode == 0
                # the process's wall beside the task's own (started to
                # finished on its row): what a process per task costs
                logger.info(
                    f'task {task_id}: run-task process exited '
                    f'{returncode} after '
                    f'{time.monotonic() - started:.2f} s',
                    ComponentType.Worker, HOSTNAME, task_id)
            # completion is pinned to THIS claim: if the lease expired
            # mid-run and the message was reclaimed, the conditional
            # UPDATE loses instead of clobbering the next claimant's run
            if ok:
                queue_provider.complete(msg_id, worker=me)
            else:
                queue_provider.fail(
                    msg_id, f'subprocess failed (rc={returncode})',
                    worker=me)
                # the process may have died before marking the task: a
                # signal kill is a preemption, a crash that wrote no
                # reason of its own is worker-lost. Only while the row is
                # still this claim's attempt: a restart (/api/dag/start)
                # landing as the process exits has reset it to NotRan,
                # and must not be overwritten
                provider = TaskProvider(session)
                task = provider.by_id(task_id)
                if task is not None and task.status in (
                        int(TaskStatus.Queued),
                        int(TaskStatus.InProgress)) and \
                        task.queue_id in (None, msg_id):
                    from mlcomp_tpu_torch.recovery import (
                        classify_returncode,
                    )
                    provider.fail_with_reason(
                        task,
                        classify_returncode(returncode) or 'worker-lost')
        elif action == 'kill':
            from mlcomp_tpu_torch.worker.tasks import kill_task
            kill_task(task_id, session=session)
            queue_provider.complete(msg_id, worker=me)
        else:
            queue_provider.fail(msg_id, f'unknown action {action!r}',
                                worker=me)
    except Exception:
        queue_provider.fail(msg_id, traceback.format_exc()[-4000:],
                            worker=me)
        logger.error(
            f'message {msg_id} ({action} task {task_id}) failed:\n'
            f'{traceback.format_exc()}',
            ComponentType.Worker, HOSTNAME, task_id)
    return True


def _error_backoff_delay(failures: int) -> float:
    """1, 2, 4, ... seconds for the Nth consecutive loop failure,
    capped at ERROR_BACKOFF_MAX_S."""
    return min(ERROR_BACKOFF_MAX_S, 2.0 ** (max(1, failures) - 1))


def _queue_channels(index: int):
    return [queue_channel(q) for q in queue_names(index)]


def _event_snapshot(session, index: int):
    """Channel snapshot taken BEFORE the claim attempt: an enqueue
    landing between an empty claim and the wait wakes the wait."""
    try:
        return session.event_snapshot(_queue_channels(index))
    except Exception:
        return None


def _idle_wait(session, index: int, snapshot=None):
    """Sleep until work may exist: wake on this worker's queue channels,
    with the short poll where no cross-process wakeup can arrive
    (sqlite across processes)."""
    timeout = EVENT_WAIT_BACKSTOP_S \
        if getattr(session, 'events_cross_process', False) \
        else QUEUE_POLL_INTERVAL
    try:
        session.wait_event(_queue_channels(index), timeout,
                           snapshot=snapshot)
    except Exception:
        time.sleep(QUEUE_POLL_INTERVAL)


def cmd_worker(args):
    """Task consumer #INDEX."""
    index = args.index
    session = Session.create_session(key=f'worker{index}')
    migrate(session)
    logger = create_logger(session)
    queue_provider = QueueProvider(session)
    logger.info(f'worker {index} consuming {queue_names(index)}',
                ComponentType.Worker, HOSTNAME)
    failures = 0
    while True:
        try:
            snapshot = _event_snapshot(session, index)
            if not _consume_one(session, queue_provider, logger, index,
                                args.in_process):
                _idle_wait(session, index, snapshot=snapshot)
            # this process runs the contended claim/complete loop the
            # busy-retry series exists for
            _flush_busy_retry_deltas(session)
            failures = 0
        except KeyboardInterrupt:
            break
        except Exception:
            failures += 1
            delay = _error_backoff_delay(failures)
            logger.error(
                f'worker loop error (consecutive failure {failures}, '
                f'backing off {delay:.0f}s):\n{traceback.format_exc()}',
                ComponentType.Worker, HOSTNAME)
            # drop the cached singleton so a fresh connection is built
            Session.cleanup(f'worker{index}')
            session = Session.create_session(key=f'worker{index}')
            queue_provider = QueueProvider(session)
            logger = create_logger(session)
            time.sleep(delay)


def cmd_run_task(args):
    """Execute one task in this process (internal). The process exits
    after the task, so the crash-time telemetry drain is installed."""
    from mlcomp_tpu_torch.worker.tasks import (
        _install_crash_flush, execute_by_id,
    )
    session = Session.create_session(key='worker')
    _install_crash_flush(session)
    execute_by_id(args.task_id, worker_index=args.index, session=session)


# --------------------------------------------------- worker supervisor
#: seconds of silence (last_activity) before the reaper fails a task
#: whose pid vanished: a process that just started may not show yet
REAPER_GRACE_S = 30


def stop_processes_not_exist(session, logger):
    """Dead-pid reaper: fail (``worker-lost``) the InProgress tasks of
    this host whose pid vanished, past the grace window."""
    provider = TaskProvider(session)
    for task in provider.by_status(TaskStatus.InProgress,
                                   computer=HOSTNAME):
        if not task.pid or procfs.pid_exists(task.pid):
            continue
        grace_ok = True
        last = parse_datetime(task.last_activity)
        if last is not None:
            grace_ok = (now() - last).total_seconds() > REAPER_GRACE_S
        if grace_ok:
            logger.error(
                f'task {task.id}: pid {task.pid} no longer exists — '
                f'marking Failed (worker-lost)',
                ComponentType.WorkerSupervisor, HOSTNAME, task.id)
            # transient: the supervisor's retry pass requeues it from
            # the last checkpoint
            provider.fail_with_reason(task, 'worker-lost')


def worker_usage(session, logger):
    """Host telemetry into the computer row and its usage history. The
    ``tpu`` field is not sampled here (this daemon holds no card): the
    value an in-process worker last wrote is kept."""
    provider = ComputerProvider(session)
    row = provider.by_name(HOSTNAME)
    prev_tpu = []
    if row is not None and row.usage:
        try:
            prev_tpu = json.loads(row.usage).get('tpu') or []
        except (ValueError, TypeError):
            pass
    usage = {
        'cpu': procfs.cpu_percent(),
        'memory': procfs.memory_percent(),
        'disk': procfs.disk_percent(ROOT_FOLDER),
        'tpu': prev_tpu or _card_usage(),
    }
    provider.current_usage(HOSTNAME, usage)
    provider.add_usage_history(HOSTNAME, usage)
    _flush_busy_retry_deltas(session)


#: watermark of _flush_busy_retry_deltas (this process only)
_BUSY_FLUSHED = {'retries': 0, 'gave_up': 0}


def _flush_busy_retry_deltas(session):
    """This process's SQLITE_BUSY retry counters into the
    ``db.busy_retries`` / ``db.busy_gave_up`` series as deltas (a SUM
    over the series stays double-count-free). Best-effort."""
    stats = busy_retry_stats()
    rows = []
    for kind, series in (('retries', 'db.busy_retries'),
                         ('gave_up', 'db.busy_gave_up')):
        delta = stats[kind] - _BUSY_FLUSHED[kind]
        if delta > 0:
            rows.append((None, series, 'counter', None, float(delta),
                         now(), 'worker_supervisor', None))
    if not rows:
        return
    try:
        MetricProvider(session).add_many(rows)
        _BUSY_FLUSHED.update({k: stats[k] for k in ('retries', 'gave_up')})
    except Exception:
        pass


def consume_control_queue(session, logger):
    """Drain the host agent's control queue
    (``{host}_{docker}_supervisor``): routed kills drain even while
    every worker is busy with a task."""
    from mlcomp_tpu_torch.worker.tasks import kill_task
    queue_provider = QueueProvider(session)
    queue = f'{HOSTNAME}_{DOCKER_IMG}_supervisor'
    me = f'{HOSTNAME}:supervisor'
    while True:
        claims = queue_provider.claim_many([queue], me, 32)
        if not claims:
            return
        for msg_id, payload in claims:
            action = payload.get('action')
            task_id = payload.get('task_id')
            try:
                if action == 'kill':
                    kill_task(task_id, session=session)
                    queue_provider.complete(msg_id, worker=me)
                else:
                    queue_provider.fail(
                        msg_id, f'unknown action {action!r}', worker=me)
            except Exception:
                queue_provider.fail(
                    msg_id, traceback.format_exc()[-4000:], worker=me)
                logger.error(
                    f'control message {msg_id} ({action} task {task_id}) '
                    f'failed:\n{traceback.format_exc()}',
                    ComponentType.WorkerSupervisor, HOSTNAME, task_id)


def cmd_worker_supervisor(args):
    """Host agent: registration, heartbeats, reaper, telemetry, control
    queue, sync."""
    from mlcomp_tpu_torch.utils.schedule import start_schedule
    from mlcomp_tpu_torch.worker.sync import FileSync

    session = Session.create_session(key='worker_supervisor')
    migrate(session)
    logger = create_logger(session)
    computer = register_computer(session, args.cores)
    docker_provider = DockerProvider(session)

    def heartbeat():
        docker_provider.heartbeat(HOSTNAME, DOCKER_IMG)

    def reaper():
        stop_processes_not_exist(session, logger)

    def usage():
        worker_usage(session, logger)

    def control():
        consume_control_queue(session, logger)

    file_sync = FileSync(session=session)
    heartbeat()
    start_schedule([
        (heartbeat, 5),
        (reaper, 10),
        (usage, WORKER_USAGE_INTERVAL),
        (file_sync.sync, 60),
        (control, 2),
    ], logger=logger)
    logger.info(f'worker-supervisor up on {HOSTNAME} '
                f'({computer.cores} cores)',
                ComponentType.WorkerSupervisor, HOSTNAME)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


# ------------------------------------------------------------------ start
def cmd_start(args):
    """Spawn worker-supervisor + N workers with autorestart."""
    from mlcomp_tpu_torch.utils.procgroup import run_process_group
    specs = [['-m', 'mlcomp_tpu_torch.worker', 'worker-supervisor']] + [
        ['-m', 'mlcomp_tpu_torch.worker', 'worker', str(i)]
        + (['--in-process'] if args.in_process else [])
        for i in range(args.n_workers)]
    run_process_group(
        specs, banner=f'started worker-supervisor + {args.n_workers} '
                      f'workers')


def cmd_stop(args):
    """SIGTERM the daemons ``start`` spawned (best effort, by command
    line)."""
    import signal
    me = os.getpid()
    for pid in procfs.process_pids():
        if pid != me and \
                'mlcomp_tpu_torch.worker' in procfs.process_cmdline(pid):
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
    print('stopped')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m mlcomp_tpu_torch.worker',
        description='Worker daemons of the port.')
    sub = parser.add_subparsers(dest='command', required=True)
    p = sub.add_parser('worker', help='task consumer #INDEX')
    p.add_argument('index', type=int)
    p.add_argument('--in-process', action='store_true',
                   help='run tasks inside the daemon (CUDA stays '
                        'initialised between tasks)')
    p.set_defaults(fn=cmd_worker)
    p = sub.add_parser('run-task', help='execute one task (internal)')
    p.add_argument('task_id', type=int)
    p.add_argument('--index', type=int, default=-1)
    p.set_defaults(fn=cmd_run_task)
    p = sub.add_parser('worker-supervisor', help='the host agent')
    p.add_argument('--cores', type=int, default=None,
                   help='override the detected card count')
    p.set_defaults(fn=cmd_worker_supervisor)
    p = sub.add_parser('start', help='worker-supervisor + N workers')
    p.add_argument('n_workers', type=int)
    p.add_argument('--in-process', action='store_true')
    p.set_defaults(fn=cmd_start)
    p = sub.add_parser('stop', help='stop the daemons start spawned')
    p.set_defaults(fn=cmd_stop)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    main()

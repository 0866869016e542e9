"""Worker task runtime (port of ``mlcomp_tpu/worker/tasks.py``).

``ExecuteBuilder`` is the per-task pipeline: fetch task+dag → check
status → mark InProgress (pid, worker index) → download code from the
DB → import the executor → pin the assigned cards → run → store the
result → requeue a multi-stage task's next stage → Success, each phase
in a telemetry span. ``execute_by_id(id)`` runs it in the calling
process: ``python -m mlcomp_tpu_torch execute`` and the in-process
worker daemon do; the daemon's default mode runs it in a
``run-task`` process of its own per task (worker/__main__.py), the
one process that exits after its task and so installs
``_install_crash_flush``.
``kill_task`` stops a task: revoke its message, kill its process tree
where it runs here, or route the kill to its host's control queue.

Where the JAX package pins ``TPU_VISIBLE_CHIPS``, this pins
``CUDA_VISIBLE_DEVICES``, which only takes effect before CUDA is
initialised. A task's multi-host ``distr_info`` is A4 and raises
(ROADMAP.md).
"""

import importlib
import json
import os
import signal
import traceback

from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.providers import (
    DagProvider, QueueProvider, TaskProvider,
)
from mlcomp_tpu_torch.telemetry.spans import (
    flush_spans, get_trace_context, set_trace_context, span,
)
from mlcomp_tpu_torch.utils.config import Config
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.logging import create_logger
from mlcomp_tpu_torch.utils.misc import hostname, set_global_seed
from mlcomp_tpu_torch.worker.storage import Storage

#: the exec-time environment marker of a task's process (set by the
#: worker when it spawns ``run-task``), read back by kill_task's
#: pid-reuse guard
TASK_ID_ENV = 'MLCOMP_TASK_ID'

#: once-per-process guard for the crash-time telemetry drain
_crash_flush_installed = False


def _install_crash_flush(session):
    """Make the telemetry of a DYING task process survive it: an atexit
    hook drains the span buffer and every live MetricRecorder, and a
    SIGTERM handler turns the signal into ``SystemExit(143)`` so
    ``finally`` blocks (span exits) run before the drain. Installed only
    by ``run-task``, whose process exits after its task: a process-wide
    handler is no business of a caller that runs a task and goes on."""
    global _crash_flush_installed
    if _crash_flush_installed:
        return
    _crash_flush_installed = True
    import atexit
    import threading

    def _drain():
        from mlcomp_tpu_torch.telemetry import (
            close_live_profilers, flush_live_recorders,
        )
        try:
            flush_spans(session)
        except Exception:
            pass
        try:
            # an open sampled window stops and parses so its devtime
            # rows land before the recorder flush below
            close_live_profilers()
        except Exception:
            pass
        flush_live_recorders()

    atexit.register(_drain)
    if threading.current_thread() is not threading.main_thread():
        return                  # the signal API is main-thread only
    previous = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        if callable(previous):
            try:
                previous(signum, frame)
            except (SystemExit, KeyboardInterrupt):
                raise
            except Exception:
                pass
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _on_term)


class ExecuteBuilder:
    def __init__(self, task_id: int, worker_index: int = -1,
                 folder: str = None, session: Session = None,
                 trace_id: str = None):
        self.task_id = task_id
        self.worker_index = worker_index
        self.folder = folder  # pre-existing code folder (debug mode)
        self.trace_id = trace_id  # from the queue payload (else info)
        self.session = session or Session.create_session(key='worker')
        self.logger = create_logger(self.session)
        self.provider = TaskProvider(self.session)
        self.dag_provider = DagProvider(self.session)
        self.storage = Storage(self.session, self.logger)
        self.queue_provider = QueueProvider(self.session)

        self.task = None
        self.dag = None
        self.executor = None

    # ------------------------------------------------------------ pipeline
    def create_base(self):
        self.task = self.provider.by_id(self.task_id)
        if self.task is None:
            raise LookupError(f'task {self.task_id} not found')
        self.dag = self.dag_provider.by_id(self.task.dag)
        set_global_seed(self.task.id)
        # tame host-side BLAS threads; the math runs on the card
        os.environ.setdefault('OMP_NUM_THREADS', '1')
        os.environ.setdefault('MKL_NUM_THREADS', '1')
        info = self.additional_info()
        for k, v in (info.get('env') or {}).items():
            os.environ[str(k)] = str(v)
        # join the submission's trace: the queue payload's, else the
        # one stored with the task. A traceless task clears any previous
        # task's context (a persistent in-process worker may still hold
        # it) so nothing inherits a stale trace
        trace_id = self.trace_id or info.get('trace_id')
        if trace_id:
            set_trace_context(trace_id, get_trace_context()[1] or 'worker')
        else:
            set_trace_context(None)

    def additional_info(self) -> dict:
        if not self.task.additional_info:
            return {}
        return yaml_load(self.task.additional_info)

    def check_status(self):
        if self.task.status == int(TaskStatus.InProgress):
            raise RuntimeError(
                f'task {self.task.id} is already InProgress')
        if self.task.status > int(TaskStatus.InProgress):
            raise RuntimeError(
                f'task {self.task.id} is already finished: '
                f'{TaskStatus(self.task.status).name}')

    def mark_in_progress(self):
        self.task.pid = os.getpid()
        self.task.worker_index = self.worker_index
        self.provider.update(self.task, ['pid', 'worker_index'])
        self.provider.change_status(self.task, TaskStatus.InProgress)

    def download(self) -> str:
        if self.folder is not None:
            folder = self.folder
        else:
            folder = self.storage.download(self.task.id, dag=self.dag)
        os.makedirs(folder, exist_ok=True)
        return folder

    def pin_cores(self):
        """Restrict CUDA to the assigned cards. ``CUDA_VISIBLE_DEVICES``
        is read once, when CUDA initialises. Where CUDA already runs in
        this process (an in-process worker after its first task, a
        caller that initialised it), the visible set can no longer
        change: a task assigned ONE card that this process sees runs
        with that card as its current device; any other assignment
        raises."""
        if not self.task.cores_assigned:
            return
        try:
            cores = json.loads(self.task.cores_assigned)
        except (TypeError, ValueError):
            return
        if not cores:
            return
        visible = ','.join(str(c) for c in cores)
        current = os.environ.get('CUDA_VISIBLE_DEVICES')
        if current == visible:
            return
        import torch
        if not torch.cuda.is_initialized():
            os.environ['CUDA_VISIBLE_DEVICES'] = visible
            return
        try:
            seen = list(range(torch.cuda.device_count())) \
                if current is None else \
                [int(c) for c in current.split(',') if c.strip()]
        except ValueError:      # cards named by UUID
            seen = []
        if len(cores) == 1 and cores[0] in seen:
            torch.cuda.set_device(seen.index(cores[0]))
            return
        raise RuntimeError(
            f'task {self.task.id} is assigned cards {visible}, but CUDA '
            f'is already initialised in this process with '
            f'CUDA_VISIBLE_DEVICES={current!r}')

    def init_distributed(self):
        """A multi-host gang's rank joins its job here in the JAX
        package; the port's distributed training is A4."""
        if self.additional_info().get('distr_info'):
            raise NotImplementedError(
                f'task {self.task.id} carries distr_info: distributed '
                f'execution is not ported yet (ROADMAP.md, A4)')

    def create_executor(self, folder: str):
        config = Config.from_yaml(self.dag.config)
        info = self.additional_info()
        executor_name = self.task.executor
        executor_type = (
            config.get('executors', {})
            .get(executor_name, {})
            .get('type', executor_name))
        self.storage.import_executor(folder, executor_type)
        executors = importlib.import_module(
            'mlcomp_tpu_torch.worker.executors')
        self.executor = executors.Executor.from_config(
            executor_name, config, additional_info=info,
            session=self.session, logger=self.logger)

    def execute(self, folder: str):
        cwd = os.getcwd()
        os.chdir(folder)
        try:
            result = self.executor(self.task, self.dag,
                                   session=self.session,
                                   logger=self.logger)
        finally:
            os.chdir(cwd)
        self.task.result = self.executor.result_serialize(result)
        self.provider.update(self.task, ['result'])

        # multi-stage: the next stage goes to this worker's own queue, or
        # (no dispatch: debug mode) runs in-process
        if isinstance(result, dict) and 'stage' in result \
                and 'stages' in result:
            stages = result['stages']
            stage = result['stage']
            idx = stages.index(stage) if stage in stages else -1
            if 0 <= idx < len(stages) - 1:
                info = self.additional_info()
                info['stage'] = stages[idx + 1]
                self._save_info(info)
                self.provider.change_status(self.task, TaskStatus.Queued)
                if self.task.queue_id is not None:
                    return self._requeue()
                return self.build()
        # a verdict may have landed on the row mid-run: a terminal one
        # wins over this run's late "it returned fine", and so does a
        # newer attempt the retry pass made of a preempted row
        current = self.provider.by_id(self.task.id)
        if current is not None and self._moved_on(current):
            return TaskStatus(current.status).name.lower()
        self.provider.change_status(self.task, TaskStatus.Success)
        return 'success'

    def _moved_on(self, current) -> bool:
        """Is the row no longer this run's to write: terminal, or on a
        newer attempt than the one this run claimed?"""
        return current.status >= int(TaskStatus.Failed) or \
            int(current.attempt or 0) != int(self.task.attempt or 0)

    def personal_queue(self) -> str:
        docker = self.task.docker_assigned or 'default'
        return f'{hostname()}_{docker}_{self.worker_index}'

    def _save_info(self, info: dict):
        self.task.additional_info = yaml_dump(info)
        self.provider.update(self.task, ['additional_info'])

    def _requeue(self) -> str:
        """Re-enqueue this task on THIS worker's personal queue and
        point the task at the new message, so kill/revoke target the
        pending dispatch, not the consumed one."""
        msg_id = self.queue_provider.enqueue(self.personal_queue(), {
            'action': 'execute', 'task_id': self.task.id})
        self.task.queue_id = msg_id
        self.provider.update(self.task, ['queue_id'])
        return 'requeued'

    def install_libraries(self):
        """Opt-in (INSTALL_LIBRARIES): check the recorded DagLibrary
        versions against this environment. With nothing to install it
        does what the JAX package does; a missing one raises, since the
        card's machine has no network to install from."""
        from mlcomp_tpu_torch import INSTALL_LIBRARIES
        if not INSTALL_LIBRARIES:
            return None
        info = self.additional_info()
        if info.get('libraries_installed') or info.get('distr_info'):
            return None
        self.storage.install_libraries(self.dag.id)
        return None

    # ----------------------------------------------------------------- main
    def build(self):
        try:
            with span('task.pipeline', task=self.task_id):
                with span('task.load'):
                    self.create_base()
                    self.check_status()
                    self.mark_in_progress()
                with span('task.download'):
                    folder = self.download()
                with span('task.install_libraries'):
                    self.install_libraries()
                self.pin_cores()
                with span('task.init_distributed'):
                    self.init_distributed()
                with span('task.create_executor',
                          tags={'executor': self.task.executor}):
                    self.create_executor(folder)
                with span('task.execute',
                          tags={'executor': self.task.executor}):
                    return self.execute(folder)
        except Exception as e:
            if self.task is not None:
                self.logger.error(
                    f'task {self.task_id} failed: '
                    f'{traceback.format_exc()}',
                    ComponentType.Worker, None, self.task_id)
                task = self.provider.by_id(self.task_id)
                if task is not None and not self._moved_on(task):
                    from mlcomp_tpu_torch.recovery import classify_exception
                    self.provider.fail_with_reason(
                        task, classify_exception(e))
            raise
        finally:
            try:
                flush_spans(self.session)
            except Exception:
                pass


def execute_by_id(task_id: int, folder: str = None, worker_index: int = -1,
                  session: Session = None, trace_id: str = None):
    return ExecuteBuilder(
        task_id, worker_index=worker_index, folder=folder,
        session=session, trace_id=trace_id).build()


def _pid_is_task_process(pid: int, task_id: int = None,
                         require_marker: bool = False) -> bool:
    """Guard against pid reuse: only a process that carries this task's
    ``MLCOMP_TASK_ID`` marker, or (in-process daemon mode, no marker) a
    process of this package, is killed. ``require_marker`` drops the
    command-line fallback: for an already-finished task, killing the
    persistent daemon itself would be worse than leaking the
    process."""
    from mlcomp_tpu_torch.utils.procfs import (
        process_cmdline, process_environ,
    )
    if task_id is not None:
        marker = process_environ(pid).get(TASK_ID_ENV)
        if marker is not None:
            # a marker naming another task: the pid was reused
            return marker == str(task_id)
    if require_marker:
        return False
    return 'mlcomp_tpu_torch' in process_cmdline(pid)


def kill_task(task_id: int, session: Session = None):
    """Stop a task: revoke its queue message if pending; kill its
    process tree if it runs on THIS host; otherwise route the kill
    through the owning host's control queue
    (``{host}_{docker}_supervisor``), which its worker-supervisor
    drains even while every worker is busy."""
    from mlcomp_tpu_torch.utils.procfs import kill_child_processes
    session = session or Session.create_session(key='worker')
    provider = TaskProvider(session)
    task = provider.by_id(task_id)
    if task is None:
        return False
    if task.queue_id is not None:
        QueueProvider(session).revoke(task.queue_id)
    # Stopped/Failed included: a routed kill arrives after the
    # initiator flipped the status, while the process still lives. For
    # Failed the marker must name THIS task (no daemon fallback)
    if task.status in (int(TaskStatus.InProgress),
                       int(TaskStatus.Stopped),
                       int(TaskStatus.Failed)) and task.pid:
        if task.computer_assigned in (None, '', hostname()):
            if _pid_is_task_process(
                    task.pid, task.id,
                    require_marker=task.status ==
                    int(TaskStatus.Failed)):
                kill_child_processes(task.pid)
                try:
                    os.kill(task.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        else:
            docker = task.docker_assigned or 'default'
            payload = {'action': 'kill', 'task_id': task.id}
            # an HA supervisor's fencing epoch, stamped for the record
            # of which leader ordered the kill (the enqueue itself is
            # fenced: a zombie's kill never reaches the queue)
            epoch = getattr(session, 'fence_epoch', None)
            if epoch is not None:
                payload['epoch'] = int(epoch)
            QueueProvider(session).enqueue(
                f'{task.computer_assigned}_{docker}_supervisor', payload)
    if task.status < int(TaskStatus.Failed):
        provider.change_status(task, TaskStatus.Stopped)
    return True


__all__ = ['ExecuteBuilder', 'execute_by_id', 'kill_task', 'TASK_ID_ENV']

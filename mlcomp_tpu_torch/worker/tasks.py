"""Worker task runtime (port of ``mlcomp_tpu/worker/tasks.py``).

``ExecuteBuilder`` is the per-task pipeline: fetch task+dag → check
status → mark InProgress (pid) → download code from the DB → import
the executor → pin the assigned cards → run → store the result → loop
a multi-stage task's next stage → Success, each phase in a telemetry
span. ``execute_by_id(id)`` runs it in-process, as
``python -m mlcomp_tpu_torch execute`` does.

Where the JAX package pins ``TPU_VISIBLE_CHIPS``, this pins
``CUDA_VISIBLE_DEVICES``, which only takes effect before CUDA is
initialised. The worker daemon's side of the JAX pipeline (exit after
the task, the worker index, the queue payload's trace id, requeueing a
stage to the worker's queue, the crash-time span drain) is the second
half of A0; a task's multi-host ``distr_info`` is A4 and raises
(ROADMAP.md).
"""

import importlib
import json
import os
import traceback

from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.enums import ComponentType, TaskStatus
from mlcomp_tpu_torch.db.providers import DagProvider, TaskProvider
from mlcomp_tpu_torch.telemetry.spans import (
    flush_spans, get_trace_context, set_trace_context, span,
)
from mlcomp_tpu_torch.utils.config import Config
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.logging import create_logger
from mlcomp_tpu_torch.utils.misc import set_global_seed
from mlcomp_tpu_torch.worker.storage import Storage


class ExecuteBuilder:
    def __init__(self, task_id: int, folder: str = None,
                 session: Session = None):
        self.task_id = task_id
        self.folder = folder  # pre-existing code folder (debug mode)
        self.session = session or Session.create_session(key='worker')
        self.logger = create_logger(self.session)
        self.provider = TaskProvider(self.session)
        self.dag_provider = DagProvider(self.session)
        self.storage = Storage(self.session, self.logger)

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
        # join the submission's trace, stored with the task; a
        # traceless task clears any previous task's context so nothing
        # inherits a stale trace
        trace_id = info.get('trace_id')
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
        self.provider.update(self.task, ['pid'])
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
        is read once, when CUDA initialises: set later it would be
        ignored, so a process whose CUDA already runs on other cards
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
        if os.environ.get('CUDA_VISIBLE_DEVICES') == visible:
            return
        import torch
        if torch.cuda.is_initialized():
            raise RuntimeError(
                f'task {self.task.id} is assigned cards {visible}, but '
                f'CUDA is already initialised in this process with '
                f'CUDA_VISIBLE_DEVICES='
                f'{os.environ.get("CUDA_VISIBLE_DEVICES")!r}')
        os.environ['CUDA_VISIBLE_DEVICES'] = visible

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

        # multi-stage: queue the next stage and run it in-process
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
                return self.build()
        # a verdict may have landed on the row mid-run: a terminal one
        # wins over this run's late "it returned fine"
        current = self.provider.by_id(self.task.id)
        if current is not None and \
                current.status >= int(TaskStatus.Failed):
            return TaskStatus(current.status).name.lower()
        self.provider.change_status(self.task, TaskStatus.Success)
        return 'success'

    def _save_info(self, info: dict):
        self.task.additional_info = yaml_dump(info)
        self.provider.update(self.task, ['additional_info'])

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
                if task is not None and task.status < int(
                        TaskStatus.Failed):
                    from mlcomp_tpu_torch.recovery import classify_exception
                    self.provider.fail_with_reason(
                        task, classify_exception(e))
            raise
        finally:
            try:
                flush_spans(self.session)
            except Exception:
                pass


def execute_by_id(task_id: int, folder: str = None,
                  session: Session = None):
    return ExecuteBuilder(task_id, folder=folder, session=session).build()


__all__ = ['ExecuteBuilder', 'execute_by_id']

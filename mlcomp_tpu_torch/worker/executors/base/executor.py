"""Executor framework — port of
``mlcomp_tpu/worker/executors/base/executor.py``.

An Executor is the unit of work a task runs. Concrete executors register
with ``@Executor.register`` under their snake_case class name; configs
name them by ``type`` (``jax_train``, the type every example config
names, is the port's ``train``). ``Executor.from_config(name, config)``
builds one from ``config['executors'][name]`` (merging a grid cell's
overrides), and calling it runs ``work()``.

With a DB session (the task pipeline, ``worker/tasks.py``) the call
tracks steps in the ``step`` table (``StepWrap``) and honours the
data-sync barrier; without one (a direct call) the step tracker logs
instead.
"""

import json
import logging
from abc import ABC, abstractmethod

from mlcomp_tpu_torch.utils.config import merge_dicts_smart
from mlcomp_tpu_torch.utils.misc import to_snake


class LogSteps:
    """The step tracker of a run without a DB: ``start(level, name)``
    and the messages go to a logger."""

    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger('mlcomp_tpu_torch.executor')

    def start(self, level: int, name: str, index: int = None):
        self.logger.info('%s%s', '  ' * (level - 1), name)

    def end_all(self):
        pass

    def debug(self, message):
        self.logger.debug(message)

    def info(self, message):
        self.logger.info(message)

    def error(self, message):
        self.logger.error(message)


class Executor(ABC):
    _registry = {}
    # module paths registered by the executors package, imported on the
    # first registry miss
    _builtin_modules = ()
    #: type names the registry resolves to another executor's key
    _aliases = {'jax_train': 'train'}

    session = None
    logger = None
    step = None
    task = None
    dag = None

    # ------------------------------------------------------------- registry
    @classmethod
    def register(cls, subclass):
        cls._registry[to_snake(subclass.__name__)] = subclass
        return subclass

    @classmethod
    def _key(cls, name: str) -> str:
        key = to_snake(name)
        return cls._aliases.get(key, key)

    @classmethod
    def _load_builtins(cls):
        import importlib
        import sys
        import mlcomp_tpu_torch.worker.executors  # noqa: F401 (the list)
        for mod in Executor._builtin_modules:
            if mod not in sys.modules:
                importlib.import_module(mod)

    @classmethod
    def is_registered(cls, name: str) -> bool:
        if cls._key(name) not in cls._registry:
            cls._load_builtins()
        return cls._key(name) in cls._registry

    @classmethod
    def get(cls, name: str):
        if cls._key(name) not in cls._registry:
            cls._load_builtins()
        return cls._registry[cls._key(name)]

    # -------------------------------------------------------------- factory
    @classmethod
    def from_config(cls, executor_name: str, config: dict,
                    additional_info: dict = None, session=None,
                    logger=None):
        """Instantiate the executor named in ``config['executors']``."""
        executors = config.get('executors', {})
        if executor_name not in executors:
            raise KeyError(
                f'executor {executor_name!r} not present in config')
        spec = dict(executors[executor_name])
        executor_type = spec.get('type', executor_name)
        subclass = cls.get(executor_type)
        additional_info = additional_info or {}
        # grid-search cell: its overrides merge into the executor spec
        cell = additional_info.get('grid')
        if cell:
            spec = merge_dicts_smart(spec, dict(cell))
        kwargs = subclass._parse_config(spec, config, additional_info)
        instance = subclass(**kwargs)
        instance.executor_name = executor_name
        instance.spec = spec
        instance.config = config
        instance.additional_info = additional_info
        instance.session = session
        instance.logger = logger
        return instance

    @classmethod
    def _parse_config(cls, executor_spec: dict, config: dict,
                      additional_info: dict) -> dict:
        """Default: pass every non-framework key as a constructor kwarg."""
        skip = {'type', 'gpu', 'cores', 'cpu', 'memory', 'depends', 'grid',
                'env', 'distr', 'single_node', 'computer', 'params',
                'report', 'slot', 'slots', 'sweep'}
        kwargs = dict(executor_spec.get('params', {}))
        for k, v in executor_spec.items():
            if k not in skip and k != 'params':
                kwargs[k] = v
        return kwargs

    # ------------------------------------------------------------ execution
    def __call__(self, task=None, dag=None, session=None, logger=None,
                 step=None):
        """Run ``work()`` inside step tracking: ``StepWrap`` rows with a
        session, log lines without one."""
        self.task = task
        self.dag = dag
        self.session = session or self.session
        self.logger = logger or self.logger
        if step is None:
            if self.session is not None:
                from mlcomp_tpu_torch.worker.executors.base.step import (
                    StepWrap,
                )
                step = StepWrap(self.session, self.logger, task).enter()
            else:
                step = LogSteps(self.logger)
        self.step = step
        if self.wait_data_sync_required():
            self.wait_data_sync()
        try:
            return self.work()
        finally:
            self.step.end_all()

    @abstractmethod
    def work(self):
        ...

    # -------------------------------------------------------------- logging
    def info(self, message):
        if self.step:
            self.step.info(message)
        elif self.logger:
            self.logger.info(message)

    def debug(self, message):
        if self.step:
            self.step.debug(message)
        elif self.logger:
            self.logger.debug(message)

    def error(self, message):
        if self.step:
            self.step.error(message)
        elif self.logger:
            self.logger.error(message)

    @classmethod
    def is_trainable(cls, executor_type: str) -> bool:
        """Trainable executors get reports and cores: the port's
        ``train`` and every name the registry aliases to it."""
        return cls._key(executor_type) == 'train'

    # ------------------------------------------------------------ data sync
    def wait_data_sync_required(self) -> bool:
        return bool(getattr(self, 'spec', {}).get('wait_sync', False))

    def wait_data_sync(self):
        """The barrier before a task reads its project's data: wait
        until every successful task of the project that ran on ANOTHER
        computer has been pulled here (FileSync, worker/sync.py); raise
        ``TimeoutError`` after 600 polls, one a second."""
        import time
        from mlcomp_tpu_torch.db.providers import TaskSyncedProvider
        from mlcomp_tpu_torch.utils.misc import hostname
        provider = TaskSyncedProvider(self.session)
        here = hostname()
        project = self.dag.project if self.dag else None
        for _ in range(600):
            pending = [entry for entry in provider.for_computer(here)
                       if project is None or entry[1] == project]
            if not pending:
                return
            time.sleep(1)
        raise TimeoutError('data sync barrier timed out')

    # -------------------------------------------------------------- helpers
    def result_serialize(self, result) -> str:
        if result is None:
            return None
        try:
            return json.dumps(result)
        except TypeError:
            return str(result)


__all__ = ['Executor', 'LogSteps']

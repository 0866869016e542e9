"""Executor framework — port of
``mlcomp_tpu/worker/executors/base/executor.py``.

An Executor is the unit of work a task runs. Concrete executors register
with ``@Executor.register`` under their snake_case class name; configs
name them by ``type``. ``Executor.from_config(name, config)`` builds one
from ``config['executors'][name]`` (merging a grid cell's overrides), and
calling it runs ``work()``.

Without a DB session (the only mode ported so far) the call runs
``work()`` with a step tracker that logs instead of writing task steps;
the DB-backed ``StepWrap`` and the data-sync barrier come with the DB
layer (ROADMAP.md, slice 4).
"""

import logging
from abc import ABC, abstractmethod
from collections import defaultdict

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


def _flatten(d: dict, sep: str, prefix: str = '') -> dict:
    out = {}
    for k, v in d.items():
        key = f'{prefix}{sep}{k}' if prefix else str(k)
        if isinstance(v, dict) and v:
            out.update(_flatten(v, sep, key))
        else:
            out[key] = v
    return out


def _unflatten(d: dict, sep: str) -> dict:
    out = {}
    for k, v in d.items():
        parts = k.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def merge_dicts_smart(target: dict, source: dict, sep: str = '/') -> dict:
    """Deep-merge ``source`` into ``target`` with suffix-path key
    matching (``mlcomp_tpu/utils/config.py``'s rule): a grid cell's
    ``lr: 0.1`` reaches ``optimizer/lr`` when that suffix is unique."""
    flat = _flatten(target, sep)
    suffix_index = defaultdict(list)
    anchors = {}
    for full in flat:
        parts = full.split(sep)
        n = len(parts)
        for i in range(n - 1, -1, -1):
            suffix_index[sep.join(parts[i:])].append(full)
            if 0 < i < n - 1:
                anchors[sep.join(parts[i:-1])] = sep.join(parts[:i + 1])
    expanded = {}
    for k, v in source.items():
        if isinstance(v, dict) and v:
            for kk, vv in _flatten(v, sep).items():
                expanded[f'{k}{sep}{kk}'] = vv
        else:
            expanded[k] = v
    for k, v in expanded.items():
        matches = suffix_index.get(k, [])
        if not matches:
            # new key: re-anchor under the deepest known interior path
            parts = k.split(sep)
            dest = k
            for i in range(len(parts) - 1, 0, -1):
                head = sep.join(parts[:i])
                if head in anchors:
                    dest = anchors[head] + sep + sep.join(parts[i:])
                    break
            matches = [dest]
        if len(matches) > 1:
            raise ValueError(
                f'ambiguous config override {k!r}: matches {matches}')
        flat[matches[0]] = v
    return _unflatten(flat, sep)


class Executor(ABC):
    _registry = {}
    # module paths registered by the executors package, imported on the
    # first registry miss
    _builtin_modules = ()

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
    def _load_builtins(cls):
        import importlib
        import sys
        import mlcomp_tpu_torch.worker.executors  # noqa: F401 (the list)
        for mod in Executor._builtin_modules:
            if mod not in sys.modules:
                importlib.import_module(mod)

    @classmethod
    def is_registered(cls, name: str) -> bool:
        if to_snake(name) not in cls._registry:
            cls._load_builtins()
        return to_snake(name) in cls._registry

    @classmethod
    def get(cls, name: str):
        if to_snake(name) not in cls._registry:
            cls._load_builtins()
        return cls._registry[to_snake(name)]

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
        """Run ``work()`` with step tracking (logged, without a DB)."""
        self.task = task
        self.dag = dag
        self.session = session or self.session
        self.logger = logger or self.logger
        if self.session is not None:
            raise NotImplementedError(
                'a DB session (task step tracking, data sync) is not ported '
                'yet (ROADMAP.md, slice 4); call the executor without one')
        self.step = step or LogSteps(self.logger)
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
        """Trainable executors get reports and cores: the JAX trainer's
        key and the port's (``train``)."""
        return to_snake(executor_type) in ('jax_train', 'train')


__all__ = ['Executor', 'LogSteps', 'merge_dicts_smart']

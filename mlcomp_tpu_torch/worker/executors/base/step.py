"""Hierarchical DB-backed step tracker (parity: reference worker/executors/base/step.py:8-123).

``start(level, name)`` opens a step at the given depth, auto-closing any
deeper or same-level open steps, and maintains ``task.current_step`` as a
dotted path. Log helpers attach rows to the innermost open step.
"""

from mlcomp_tpu_torch.db.enums import ComponentType
from mlcomp_tpu_torch.db.models import Step
from mlcomp_tpu_torch.db.providers import StepProvider, TaskProvider
from mlcomp_tpu_torch.utils.misc import now


class StepWrap:
    def __init__(self, session, logger, task, component=None):
        self.session = session
        self.logger = logger
        self.task = task
        self.component = component or ComponentType.Worker
        self.step_provider = StepProvider(session)
        self.task_provider = TaskProvider(session)
        self.stack = []  # open Step objects, outermost first

    # ------------------------------------------------------------ lifecycle
    def enter(self):
        """Open the root step (level 1)."""
        self.start(1, self.task.executor or 'task')
        return self

    def start(self, level: int, name: str, index: int = None):
        assert level >= 1, 'step level must be >= 1'
        self.finish_deeper(level)
        step = Step(
            task=self.task.id, level=level, name=name,
            index=index if index is not None else 0, started=now())
        self.step_provider.add(step)
        self.stack.append(step)
        self._update_current()
        return step

    def finish_deeper(self, level: int):
        """Close open steps at `level` or deeper."""
        while self.stack and self.stack[-1].level >= level:
            self.end_step()

    def end_step(self):
        if not self.stack:
            return
        step = self.stack.pop()
        step.finished = now()
        self.step_provider.update(step, ['finished'])
        self._update_current()

    def end_all(self):
        while self.stack:
            self.end_step()

    def _update_current(self):
        self.task.current_step = '.'.join(s.name for s in self.stack) or None
        self.task_provider.update(self.task, ['current_step'])

    @property
    def current(self):
        return self.stack[-1] if self.stack else None

    # -------------------------------------------------------------- logging
    def _log(self, fn, message):
        step_id = self.current.id if self.current else None
        fn(message, self.component, None, self.task.id, step_id)

    def debug(self, message):
        self._log(self.logger.debug, message)

    def info(self, message):
        self._log(self.logger.info, message)

    def warning(self, message):
        self._log(self.logger.warning, message)

    def error(self, message):
        self._log(self.logger.error, message)


__all__ = ['StepWrap']

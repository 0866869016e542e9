"""Executors of the port (counterpart of ``mlcomp_tpu/worker/executors``).

The builtin executors register on the first registry miss, so code that
only looks names up never imports the training stack.
"""

from mlcomp_tpu_torch.worker.executors.base import Executor

Executor._builtin_modules = ('mlcomp_tpu_torch.train.executor',)

__all__ = ['Executor']

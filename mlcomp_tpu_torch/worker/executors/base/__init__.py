from mlcomp_tpu_torch.worker.executors.base.executor import Executor

__all__ = ['Executor']

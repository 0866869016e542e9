from mlcomp_tpu_torch.worker.executors.base.executor import Executor
from mlcomp_tpu_torch.worker.executors.base.step import StepWrap

__all__ = ['Executor', 'StepWrap']

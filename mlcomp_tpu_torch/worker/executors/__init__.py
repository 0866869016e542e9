"""Executors of the port (counterpart of ``mlcomp_tpu/worker/executors``).

The builtin executors register on the first registry miss, so code that
only looks names up never imports the training stack: ``train``, the
Equation family (``equation``, ``infer``, ``infer_classify``, ``valid``,
``valid_classify``, ``valid_segment``), ``split`` (a fold file),
``prepare_submit`` / ``submit_classify`` (a submission csv),
``model_add`` (the model registry), ``serve_replica`` (one replica of a
serving fleet) and ``sweep_probe`` (a synthetic ASHA sweep cell).
"""

from mlcomp_tpu_torch.worker.executors.base import Executor

Executor._builtin_modules = (
    'mlcomp_tpu_torch.train.executor',
    'mlcomp_tpu_torch.worker.executors.split',
    'mlcomp_tpu_torch.worker.executors.base.equation',
    'mlcomp_tpu_torch.worker.executors.infer',
    'mlcomp_tpu_torch.worker.executors.valid',
    'mlcomp_tpu_torch.worker.executors.prepare_submit',
    'mlcomp_tpu_torch.worker.executors.model',
    'mlcomp_tpu_torch.worker.executors.serve_replica',
    'mlcomp_tpu_torch.worker.executors.sweep_probe',
)

__all__ = ['Executor']

"""DAG builders (``mlcomp_tpu/server/create_dags``): the standard one,
``dag_pipe`` (a ``pipes:`` config), ``dag_model_add`` and
``dag_model_start`` (the model registry)."""

from mlcomp_tpu_torch.server.create_dags.model_add import dag_model_add
from mlcomp_tpu_torch.server.create_dags.model_start import dag_model_start
from mlcomp_tpu_torch.server.create_dags.pipe import dag_pipe
from mlcomp_tpu_torch.server.create_dags.standard import dag_standard

__all__ = ['dag_standard', 'dag_pipe', 'dag_model_add', 'dag_model_start']

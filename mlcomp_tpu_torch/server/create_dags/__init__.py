"""DAG builders (``mlcomp_tpu/server/create_dags``): the standard one;
``dag_pipe``, ``dag_model_add`` and ``dag_model_start`` come with the
second half of A0 (ROADMAP.md)."""

from mlcomp_tpu_torch.server.create_dags.standard import dag_standard

__all__ = ['dag_standard']

"""The worker side of the port (counterpart of ``mlcomp_tpu/worker``):
the executor framework and its registry, code storage (``storage``) and
the task pipeline (``tasks``)."""

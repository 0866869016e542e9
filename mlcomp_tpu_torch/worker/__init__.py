"""The worker side of the port (counterpart of ``mlcomp_tpu/worker``):
so far only the executor framework and its registry."""

"""Serving process of the port (counterpart of ``mlcomp_tpu/server``;
only ``serve`` is ported so far)."""

"""Training of the port (counterpart of ``mlcomp_tpu/train``): losses and
steps, optimizers, datasets, checkpoints, export and the ``train``
executor; plus the parameter-layout helpers."""

"""Contributed host-side pieces of the port (counterpart of
``mlcomp_tpu/contrib``): the numpy metrics, the host augment pipeline
and the RLE mask codec, test-time augmentation, the segmentation losses
(``criterion``) and the array-file dataset that the export consumers
(``worker/executors/infer.py``, ``valid.py``) use."""

"""Contributed host-side pieces of the port (counterpart of
``mlcomp_tpu/contrib``): so far the numpy metrics, test-time
augmentation and the array-file dataset that the export consumers
(``worker/executors/infer.py``, ``valid.py``) use."""

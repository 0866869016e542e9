"""Contributed host-side pieces of the port (counterpart of
``mlcomp_tpu/contrib``): the numpy metrics, the host augment pipeline
and the RLE mask codec, test-time augmentation, the segmentation losses
(``criterion``), the fold splitters (``split``) and their command line
(``python -m mlcomp_tpu_torch.contrib``), and the array-file and image
folder datasets (``dataset``) that the export consumers
(``worker/executors/infer.py``, ``valid.py``, ``prepare_submit.py``)
use."""

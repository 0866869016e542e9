"""Export, predictor and parameter-layout helpers of the port
(counterpart of ``mlcomp_tpu/train``; training itself is not ported
yet)."""

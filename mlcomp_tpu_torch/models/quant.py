"""Quantized-training layers — port of ``mlcomp_tpu/models/quant.py``.

``Int8DenseGeneral`` stands where ``models/transformer.py``'s ``Dense``
stands at ``matmul_precision: int8``, with the same parameter: one
``weight`` [out, in] of ``param_dtype``, the same ``state_dict`` key, so
a checkpoint trained at one precision restores into the other (and into
the JAX package's, whose ``Int8DenseGeneral`` keeps ``DenseGeneral``'s
``kernel``): the precision is a property of the step, not of the saved
state.

The product is ``ops/int8_matmul.py``'s ``Int8TrainMatmul``: x (as it
arrives, upcast to f32) quantized per row and the weight quantized from
the STORED parameter (f32 or bf16, not a copy cast to ``dtype``) per
output channel — a row of the port's [out, in] weight, a column of JAX's
[in, out] kernel — both every step, exact int8 products, f32 sums,
straight-through gradients, int8 residuals saved for the backward. The
compute dtype is the model's ``dtype``; the output is cast to it.
"""

import torch
from torch import nn

from mlcomp_tpu_torch.ops.int8_matmul import int8_train_matmul


class Int8DenseGeneral(nn.Module):
    """The int8 training twin of ``Dense`` (bias-free, as the
    transformer's projections are). ``weight`` is ``[out, in]``."""

    def __init__(self, d_in: int, d_out: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=param_dtype, device=device))

    def forward(self, x):
        lead = x.shape[:-1]
        y = int8_train_matmul(x.reshape(-1, x.shape[-1]), self.weight,
                              self.dtype)
        return y.to(self.dtype).reshape(*lead, self.weight.shape[0])


__all__ = ['Int8DenseGeneral']

"""MLP classifier, the digit-recognizer workload — port of
``mlcomp_tpu/models/mlp.py``.

``forward(x)`` flattens each example (NHWC images as they come, so the
features are in the JAX package's order), runs the hidden layers in
``dtype`` with a ReLU after each, and the head in f32. Parameter names
follow the JAX tree: ``dense_i`` and ``head``, each a ``weight`` [out,
in] (the JAX ``kernel`` transposed) and a ``bias``.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.resnet import Dense
from mlcomp_tpu_torch.models.transformer import torch_dtype


class MLP(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 10,
                 hidden: Sequence[int] = (256, 256), dtype='float32',
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.hidden = []
        d = in_features
        for i, h in enumerate(hidden):
            self.add_module(f'dense_{i}', Dense(d, h, self.dtype, device))
            self.hidden.append(f'dense_{i}')
            d = h
        self.head = Dense(d, num_classes, torch.float32, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(self.head.weight.device).manual_seed(0)
        for name in self.hidden + ['head']:
            getattr(self, name).reset_parameters(generator)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits [N, num_classes] f32; ``train`` and ``generator`` are
        accepted for the train step's sake (no dropout here)."""
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for name in self.hidden:
            x = F.relu(getattr(self, name)(x))
        return self.head(x)


@register_model('mlp')
def _mlp(num_classes=10, hidden=(256, 256), dtype='float32',
         input_shape=None, mesh=None, device=None, generator=None, **_):
    """The JAX factory's keys; ``input_shape`` (without the batch, as an
    export records it) gives the input features, 8x8x1 (digits) by
    default."""
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh is not ported yet (ROADMAP.md, queue A: A4)')
    in_features = math.prod(input_shape) if input_shape else 64
    return MLP(int(in_features), num_classes=num_classes,
               hidden=tuple(hidden), dtype=dtype, device=device,
               generator=generator)


__all__ = ['MLP']

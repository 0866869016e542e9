"""The standalone U-Net — port of ``mlcomp_tpu/models/unet.py``,
registered as ``unet`` (the encoder-based U-Nets are ``unet_{encoder}``
in ``models/segmentation.py``).

``down_i`` blocks each followed by a 2x2 (VALID) max-pool, a
``bottleneck``, ``up_i`` blocks after a x2 nearest upsampling and the
skip's concatenation, and an f32 1x1 ``head`` with a bias. NHWC images
in (height and width divisible by 2^(levels - 1)), f32 NHWC logits out.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.resnet import (
    BatchNorm, Conv, init_parameters, max_pool_valid, to_nchw,
)
from mlcomp_tpu_torch.models.transformer import torch_dtype


class ConvBlock(nn.Module):
    """Two 3x3 conv + norm + ReLU (flax's auto-names ``Conv_j`` /
    ``BatchNorm_j``)."""

    def __init__(self, c_in: int, filters: int, dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 3, dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype, device=device)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device)

    def forward(self, x, train: bool = False):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return F.relu(self.BatchNorm_1(self.Conv_1(x), train))


class UNet(nn.Module):
    def __init__(self, num_classes: int = 2,
                 filters: Sequence[int] = (32, 64, 128, 256),
                 dtype='bfloat16', in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        filters = tuple(int(f) for f in filters)
        self.levels = len(filters) - 1
        c = in_channels
        for i, f in enumerate(filters[:-1]):
            self.add_module(f'down_{i}', ConvBlock(c, f, self.dtype, device))
            c = f
        self.bottleneck = ConvBlock(c, filters[-1], self.dtype, device)
        c = filters[-1]
        for i, f in reversed(list(enumerate(filters[:-1]))):
            self.add_module(f'up_{i}', ConvBlock(c + f, f, self.dtype, device))
            c = f
        self.head = Conv(c, num_classes, 1, dtype=torch.float32,
                         device=device, bias=True, init='lecun')
        init_parameters(self, generator)

    def forward(self, x, train: bool = False, generator=None):
        x = to_nchw(x, self.dtype)
        skips = []
        for i in range(self.levels):
            x = getattr(self, f'down_{i}')(x, train)
            skips.append(x)
            x = max_pool_valid(x)
        x = self.bottleneck(x, train)
        for i in reversed(range(self.levels)):
            # nearest x2: an integer factor, where 'nearest' is exact
            x = F.interpolate(x, scale_factor=2, mode='nearest')
            x = torch.cat([x, skips[i]], dim=1)
            x = getattr(self, f'up_{i}')(x, train)
        return self.head(x).permute(0, 2, 3, 1)


@register_model('unet')
def _unet(num_classes=2, filters=(32, 64, 128, 256), dtype='bfloat16',
          input_shape=None, mesh=None, device=None, generator=None, **_):
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh is not ported yet (ROADMAP.md, queue A: A4)')
    return UNet(num_classes, tuple(filters), dtype,
                in_channels=int(input_shape[-1]) if input_shape else 3,
                device=device, generator=generator)


__all__ = ['UNet', 'ConvBlock']

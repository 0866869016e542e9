"""Segmentation zoo — port of ``mlcomp_tpu/models/segmentation.py``: the
ResNet pyramid encoder, the FPN / LinkNet / PSPNet / DeepLabV3 / U-Net
decoders over any encoder family, and their registry names (each bare
decoder, ``{decoder}_{encoder}`` and ``unet_{encoder}`` for every
encoder).

A model takes NHWC images, as the JAX package does, and returns f32
logits [N, H, W, classes] (NHWC) at the input's resolution. Inside,
activations are NCHW channels_last tensors in ``dtype``; the class
projection (``classifier``, with a bias) and the final resize run in
f32.

``resize_to`` is ``jax.image.resize``: ``bilinear`` is
``F.interpolate(mode='bilinear', align_corners=False)``, antialiased
where a dimension shrinks (JAX antialiases by default; upsampling is the
same either way), and ``nearest`` is ``mode='nearest-exact'`` (plain
``nearest`` picks other pixels at non-integer ratios).

Parameter and buffer names are the flax variable paths joined with dots:
the encoder is ``{EncoderClass}_0`` (flax's auto-name), a
``_conv_norm_act`` named ``n`` is ``n_conv`` / ``n_norm`` on the
decoder itself, so ``convert.image_state_dict_from_jax`` carries the
weights both ways.
"""

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.resnet import (
    BasicBlock, BatchNorm, Bottleneck, Conv, NormFactory, avg_pool_valid,
    init_parameters, max_pool_same, to_nchw,
)
from mlcomp_tpu_torch.models.transformer import torch_dtype


class ResNetEncoder(nn.Module):
    """ResNet trunk returning the feature pyramid [c1..c5] of an NCHW
    input already in ``dtype``; ``channels`` lists their widths. A stage
    with ``stage_dilations[i]`` > 1 keeps its resolution (stride 1) and
    dilates its 3x3s (DRN)."""

    def __init__(self, stage_sizes: Sequence[int], block,
                 num_filters: int = 64, cifar_stem: bool = False,
                 dtype=torch.bfloat16,
                 stage_dilations: Sequence[int] = (1, 1, 1, 1),
                 in_channels: int = 3, device=None):
        super().__init__()
        self.cifar_stem = cifar_stem
        norms = NormFactory('batch', dtype, device=device)
        if cifar_stem:
            self.conv_stem = norms.conv(in_channels, num_filters, 3)
        else:
            self.conv_stem = norms.conv(in_channels, num_filters, 7, 2)
        self.norm_stem = norms(num_filters)
        # SEBasicBlock is partial(BasicBlock, se=True): still BasicBlock_i
        cls = getattr(block, 'func', block)
        c = num_filters
        self.channels = [c]
        self.stages = []
        for i, n_blocks in enumerate(stage_sizes):
            dil = int(stage_dilations[i]) if i < len(stage_dilations) else 1
            names = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 and dil == 1 else 1
                name = f'{cls.__name__}_{sum(map(len, self.stages)) + j}'
                self.add_module(name, block(c, num_filters * 2 ** i, norms,
                                            stride, dilation=dil))
                names.append(name)
                c = num_filters * 2 ** i * cls.expansion
            self.stages.append(names)
            self.channels.append(c)

    def forward(self, x, train: bool = False):
        x = F.relu(self.norm_stem(self.conv_stem(x), train))
        features = [x]
        if not self.cifar_stem:
            x = max_pool_same(x)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, train)
            features.append(x)
        return features


_ENCODERS = {
    'resnet18': ([2, 2, 2, 2], BasicBlock),
    'resnet34': ([3, 4, 6, 3], BasicBlock),
    'resnet50': ([3, 4, 6, 3], Bottleneck),
    'resnet101': ([3, 4, 23, 3], Bottleneck),
}


def make_encoder(encoder: str, dtype, cifar_stem: bool = False,
                 in_channels: int = 3, device=None):
    """The encoder module of any family (``encoders.make_family_encoder``;
    the ResNets resolve to ``_ENCODERS``)."""
    from mlcomp_tpu_torch.models.encoders import make_family_encoder
    return make_family_encoder(encoder, dtype, cifar_stem, in_channels,
                               device)


def resize_to(x, target_hw, method: str = 'bilinear'):
    """``jax.image.resize`` of an NCHW ``x`` to ``target_hw``."""
    target_hw = tuple(int(d) for d in target_hw)
    if tuple(x.shape[2:]) == target_hw:
        return x
    if method == 'nearest':
        return F.interpolate(x, size=target_hw, mode='nearest-exact')
    if method != 'bilinear':
        raise ValueError(f'unknown resize method {method!r}')
    if all(t >= s for t, s in zip(target_hw, x.shape[2:])):
        return F.interpolate(x, size=target_hw, mode='bilinear',
                             align_corners=False)
    # the antialiased kernel has no bf16 CPU version: it runs in f32
    y = F.interpolate(x.float(), size=target_hw, mode='bilinear',
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


class _SegmentationBase(nn.Module):
    """The encoder, the ``_conv_norm_act`` sites and the f32 head shared by
    the decoders. ``FIELDS`` names the decoder's own keyword fields (what
    ``_seg_factory`` passes on from a spec)."""

    FIELDS = ()

    def __init__(self, num_classes: int = 2, encoder: str = 'resnet18',
                 dtype='bfloat16', cifar_stem: bool = False,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.num_classes = num_classes
        self._device = device
        enc = make_encoder(encoder, self.dtype, cifar_stem, in_channels,
                           device)
        self.encoder_key = f'{type(enc).__name__}_0'
        self.add_module(self.encoder_key, enc)
        self.enc_channels = enc.channels

    def _conv(self, c_in, c_out, kernel, **kw):
        return Conv(c_in, c_out, kernel, dtype=self.dtype, device=self._device,
                    **kw)

    def _cna(self, name: str, c_in: int, c_out: int, kernel):
        """``_conv_norm_act``'s parameters: ``{name}_conv`` (no bias) and
        ``{name}_norm``."""
        self.add_module(f'{name}_conv', self._conv(c_in, c_out, kernel))
        self.add_module(f'{name}_norm', BatchNorm(c_out, self.dtype,
                                                  self._device))

    def cna(self, name: str, x, train: bool):
        x = getattr(self, f'{name}_conv')(x)
        return F.relu(getattr(self, f'{name}_norm')(x, train))

    def _head(self, c_in: int, generator):
        self.classifier = Conv(c_in, self.num_classes, 1, dtype=torch.float32,
                               device=self._device, bias=True, init='lecun')
        init_parameters(self, generator)

    def encode(self, x, train: bool):
        return getattr(self, self.encoder_key)(to_nchw(x, self.dtype), train)

    def head(self, x, input_hw):
        """Classes in f32, resized to the input: NHWC logits."""
        x = resize_to(self.classifier(x.float()), input_hw)
        return x.permute(0, 2, 3, 1)


class FPN(_SegmentationBase):
    """Feature Pyramid Network decoder: lateral 1x1s (with bias) and
    top-down adds, per-level 3x3 blocks merged by summation at c2's
    scale."""

    FIELDS = ('pyramid_channels', 'segmentation_channels')

    def __init__(self, num_classes=2, encoder='resnet18', dtype='bfloat16',
                 cifar_stem=False, pyramid_channels: int = 128,
                 segmentation_channels: int = 64, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, encoder, dtype, cifar_stem,
                         in_channels, device)
        for level in (5, 4, 3, 2):
            self.add_module(f'lateral{level}', self._conv(
                self.enc_channels[level - 1], pyramid_channels, 1, bias=True))
        for i in range(4):
            self._cna(f'seg{i}', pyramid_channels, segmentation_channels, 3)
        self._head(segmentation_channels, generator)

    def forward(self, x, train: bool = False, generator=None):
        input_hw = x.shape[1:3]
        _, c2, c3, c4, c5 = self.encode(x, train)
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + resize_to(p5, c4.shape[2:])
        p3 = self.lateral3(c3) + resize_to(p4, c3.shape[2:])
        p2 = self.lateral2(c2) + resize_to(p3, c2.shape[2:])
        merged = None
        for i, p in enumerate((p5, p4, p3, p2)):
            s = resize_to(self.cna(f'seg{i}', p, train), c2.shape[2:])
            merged = s if merged is None else merged + s
        return self.head(merged, input_hw)


class LinkNet(_SegmentationBase):
    """LinkNet decoder: bottlenecked up-blocks with additive skips."""

    def __init__(self, num_classes=2, encoder='resnet18', dtype='bfloat16',
                 cifar_stem=False, in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, encoder, dtype, cifar_stem,
                         in_channels, device)
        c = self.enc_channels[4]
        for i, ch in enumerate(reversed(self.enc_channels[1:4])):
            mid = max(ch // 4, 16)
            self._cna(f'up{i}_reduce', c, mid, 1)
            self._cna(f'up{i}_conv', mid, mid, 3)
            self._cna(f'up{i}_expand', mid, ch, 1)
            c = ch
        self._cna('final', c, 32, 3)
        self._head(32, generator)

    def forward(self, x, train: bool = False, generator=None):
        input_hw = x.shape[1:3]
        feats = self.encode(x, train)
        y = feats[4]
        for i, skip in enumerate(reversed(feats[1:4])):
            y = self.cna(f'up{i}_reduce', y, train)
            y = resize_to(y, skip.shape[2:])
            y = self.cna(f'up{i}_conv', y, train)
            y = self.cna(f'up{i}_expand', y, train)
            y = y + skip
        return self.head(self.cna('final', y, train), input_hw)


class PSPNet(_SegmentationBase):
    """Pyramid Scene Parsing decoder: c5 average-pooled with a window (and
    stride) of (h // bins, w // bins), VALID, as JAX pools it (not an
    adaptive pool), projected, resized back, concatenated and fused."""

    FIELDS = ('bins', 'psp_channels')

    def __init__(self, num_classes=2, encoder='resnet18', dtype='bfloat16',
                 cifar_stem=False, bins: Sequence[int] = (1, 2, 3, 6),
                 psp_channels: int = 128, in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, encoder, dtype, cifar_stem,
                         in_channels, device)
        self.bins = tuple(int(b) for b in bins)
        c5 = self.enc_channels[4]
        for bi in range(len(self.bins)):
            self._cna(f'psp{bi}', c5, psp_channels, 1)
        self._cna('fuse', c5 + len(self.bins) * psp_channels,
                  psp_channels * 2, 3)
        self._head(psp_channels * 2, generator)

    def forward(self, x, train: bool = False, generator=None):
        input_hw = x.shape[1:3]
        c5 = self.encode(x, train)[4]
        h, w = c5.shape[2:]
        pooled = [c5]
        for bi, bins in enumerate(self.bins):
            p = avg_pool_valid(c5, (max(h // bins, 1), max(w // bins, 1)))
            p = self.cna(f'psp{bi}', p, train)
            pooled.append(resize_to(p, (h, w)))
        y = self.cna('fuse', torch.cat(pooled, dim=1), train)
        return self.head(y, input_hw)


class DeepLabV3(_SegmentationBase):
    """ASPP decoder: parallel atrous convs (1x1 at rate 1, else 3x3
    dilated) and image-level pooling, concatenated and projected."""

    FIELDS = ('aspp_channels', 'rates')

    def __init__(self, num_classes=2, encoder='resnet18', dtype='bfloat16',
                 cifar_stem=False, aspp_channels: int = 128,
                 rates: Sequence[int] = (1, 6, 12, 18), in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, encoder, dtype, cifar_stem,
                         in_channels, device)
        self.rates = tuple(int(r) for r in rates)
        c5 = self.enc_channels[4]
        for ri, rate in enumerate(self.rates):
            self.add_module(f'aspp{ri}_conv', self._conv(
                c5, aspp_channels, 1 if rate == 1 else 3, dilation=rate))
            self.add_module(f'aspp{ri}_norm', BatchNorm(
                aspp_channels, self.dtype, device))
        self._cna('img_pool', c5, aspp_channels, 1)
        self._cna('project', (len(self.rates) + 1) * aspp_channels,
                  aspp_channels, 1)
        self._head(aspp_channels, generator)

    def forward(self, x, train: bool = False, generator=None):
        input_hw = x.shape[1:3]
        c5 = self.encode(x, train)[4]
        branches = [self.cna(f'aspp{ri}', c5, train)
                    for ri in range(len(self.rates))]
        img_pool = c5.mean(dim=(2, 3), keepdim=True)
        img_pool = self.cna('img_pool', img_pool, train)
        branches.append(resize_to(img_pool, c5.shape[2:], method='nearest'))
        y = self.cna('project', torch.cat(branches, dim=1), train)
        return self.head(y, input_hw)


class UNetDecoder(_SegmentationBase):
    """U-Net decoder over any pyramid encoder: upsample, concatenate the
    skip, two 3x3 conv-norm-ReLU blocks per level."""

    FIELDS = ('decoder_channels',)

    def __init__(self, num_classes=2, encoder='resnet18', dtype='bfloat16',
                 cifar_stem=False,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, encoder, dtype, cifar_stem,
                         in_channels, device)
        c = self.enc_channels[4]
        skips = self.enc_channels[:4][::-1]
        self.levels = len(list(zip(skips, decoder_channels)))
        for i, (skip, ch) in enumerate(zip(skips, decoder_channels)):
            self._cna(f'dec{i}_a', c + skip, ch, 3)
            self._cna(f'dec{i}_b', ch, ch, 3)
            c = ch
        self._head(c, generator)

    def forward(self, x, train: bool = False, generator=None):
        input_hw = x.shape[1:3]
        feats = self.encode(x, train)
        y = feats[4]
        for i, skip in enumerate(feats[:4][::-1][:self.levels]):
            y = resize_to(y, skip.shape[2:])
            y = torch.cat([y, skip.to(y.dtype)], dim=1)
            y = self.cna(f'dec{i}_a', y, train)
            y = self.cna(f'dec{i}_b', y, train)
        return self.head(y, input_hw)


_DECODERS = {'fpn': FPN, 'linknet': LinkNet, 'pspnet': PSPNet,
             'deeplabv3': DeepLabV3}


def _seg_factory(decoder_cls):
    def factory(num_classes=2, encoder='resnet18', dtype='bfloat16',
                cifar_stem=False, input_shape=None, mesh=None, device=None,
                generator=None, **kwargs):
        if mesh is not None:
            raise NotImplementedError(
                'a device mesh is not ported yet (ROADMAP.md, queue A: A4)')
        extra = {k: v for k, v in kwargs.items() if k in decoder_cls.FIELDS}
        return decoder_cls(
            num_classes=num_classes, encoder=encoder, dtype=dtype,
            cifar_stem=bool(cifar_stem), **extra,
            in_channels=int(input_shape[-1]) if input_shape else 3,
            device=device, generator=generator)
    return factory


def _all_encoder_names():
    from mlcomp_tpu_torch.models.encoders import ENCODER_FACTORIES
    return list(_ENCODERS) + list(ENCODER_FACTORIES)


def _alias(decoder_cls, encoder, num_classes=2, dtype='bfloat16',
           cifar_stem=False, **kwargs):
    return _seg_factory(decoder_cls)(
        num_classes=num_classes, encoder=encoder, dtype=dtype,
        cifar_stem=cifar_stem, **kwargs)


def _register_aliases(prefix, decoder_cls, bare_name=False):
    """Register ``{prefix}_{encoder}`` for every encoder family (and
    optionally the bare decoder name)."""
    if bare_name:
        register_model(prefix)(_seg_factory(decoder_cls))
    for enc in _all_encoder_names():
        register_model(f'{prefix}_{enc}')(partial(_alias, decoder_cls, enc))


for _dec_name, _cls in _DECODERS.items():
    _register_aliases(_dec_name, _cls, bare_name=True)
# the bare 'unet' stays the standalone models/unet.py module
_register_aliases('unet', UNetDecoder)


__all__ = ['ResNetEncoder', 'FPN', 'LinkNet', 'PSPNet', 'DeepLabV3',
           'UNetDecoder', 'make_encoder', 'resize_to']

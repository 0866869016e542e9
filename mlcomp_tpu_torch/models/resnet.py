"""ResNet family (CIFAR and ImageNet stems) — port of
``mlcomp_tpu/models/resnet.py``.

The JAX model's numerics and parameter tree, as ``nn.Module``s:

- the input is NHWC, as in the JAX package (an export's
  ``input_shape``); inside, activations are NCHW tensors in
  ``torch.channels_last`` memory, which is NHWC in memory, so a norm
  site's ``[R, C]`` rows (R = N·H·W) are a view of the activation and
  not a copy;
- convolutions are flax ``nn.Conv`` with ``padding='SAME'``, which pads
  *asymmetrically* where the total padding is odd (a 3×3 stride-2 conv
  on an even input pads 0 before and 1 after, the 7×7 stride-2 stem 2
  and 3, the stem's 3×3 stride-2 max-pool 0 and 1). ``same_pads``
  computes flax's split, and an odd one goes through an explicit
  ``F.pad`` before a conv with ``padding=0``;
- activations run in ``dtype`` (bf16 by default) from f32 params;
- ``norm``: ``batch`` (flax ``nn.BatchNorm``), ``fused`` (the fused
  batch-norm+ReLU of ``ops/fused_norm.py``: the CUDA kernel on the card
  in train mode; the plain version with the running statistics in eval,
  as in JAX) or ``none`` (weight-standardised convs and a zero-init
  SkipInit gain at each residual-branch end). ``batch`` and ``fused``
  have the same parameters and statistics, so their checkpoints
  interchange.

Running statistics follow flax, not ``torch.nn.BatchNorm2d``: the
biased batch variance, ``new = 0.9 * old + 0.1 * batch``, updated in
place in each train-mode forward (module buffers ``mean`` and ``var``).

Module and parameter names follow the JAX tree (``conv_stem``,
``norm_stem``, ``BasicBlock_i`` with ``Conv_j``/``BatchNorm_j``/
``conv_proj``/``norm_proj``, ``head``), so ``convert.py`` maps one onto
the other leaf by leaf: a conv's ``kernel`` [kh, kw, in, out] is the
port's ``weight`` [out, in, kh, kw], a dense ``kernel`` [in, out] its
``weight`` [out, in].
"""

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.transformer import torch_dtype
from mlcomp_tpu_torch.ops.fused_norm import (
    fused_norm_act, reference_norm_act, resolve_norm_impl,
)

MOMENTUM = 0.9
EPSILON = 1e-5


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """(before, after) padding of one spatial dim under flax/XLA 'SAME':
    the output has ceil(size / stride) positions and an odd total pad
    puts the extra pixel after."""
    out = -(-size // stride)
    extent = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last)


def conv_same(x, weight, stride: int = 1, dilation: int = 1, groups: int = 1,
              bias=None):
    """``lax.conv_general_dilated(..., padding='SAME')`` over an NCHW
    (channels_last) x and an OIHW weight (grouped: [out, in/groups, kh,
    kw], flax's ``feature_group_count``), plus ``bias``."""
    kh, kw = weight.shape[2:]
    ph = same_pads(x.shape[2], kh, stride, dilation)
    pw = same_pads(x.shape[3], kw, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride=stride,
                        padding=(ph[0], pw[0]), dilation=dilation,
                        groups=groups)
    x = _channels_last(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))
    return F.conv2d(x, weight, bias, stride=stride, dilation=dilation,
                    groups=groups)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax ``nn.max_pool(..., padding='SAME')``: padding never wins."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float('-inf'))
    return F.max_pool2d(_channels_last(x), kernel, stride)


def max_pool_valid(x, kernel: int = 2):
    """flax ``nn.max_pool(x, (k, k), strides=(k, k))`` (VALID): a ragged
    edge is dropped."""
    return F.max_pool2d(x, kernel, kernel)


def avg_pool_valid(x, kernel):
    """flax ``nn.avg_pool(x, kernel, strides=kernel)`` (VALID)."""
    return F.avg_pool2d(x, kernel, kernel)


def to_nchw(x, dtype):
    """NHWC images of any dtype as the NCHW channels_last ``dtype``
    tensor the convolutions take."""
    return _channels_last(x.to(dtype).permute(0, 3, 1, 2))


@torch.no_grad()
def init_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None):
    """Draw every parameter of ``model`` from its JAX initialiser's
    distribution (each leaf module's ``reset_parameters``); the numbers
    differ from JAX's, so tests hand both packages the same weights."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device).manual_seed(0)
    for module in model.modules():
        if module is not model and hasattr(module, 'reset_parameters'):
            module.reset_parameters(generator)


def _param(shape, device, fill: Optional[float] = None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Conv(nn.Module):
    """flax ``nn.Conv``: the input and the f32 kernel cast to ``dtype``,
    'SAME' padding. ``weight`` is OIHW ([out, in/groups, kh, kw] for
    ``groups`` > 1, flax's ``feature_group_count``); ``bias`` (flax's
    ``use_bias``) starts at zero. ``init``: ``fan_out`` is the zoo's
    ``conv_kernel_init`` (variance_scaling(2.0, 'fan_out', 'normal')),
    ``lecun`` flax's default kernel initialiser."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1,
                 dilation: int = 1, dtype=torch.bfloat16, device=None,
                 groups: int = 1, bias: bool = False, init: str = 'fan_out'):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if init not in ('fan_out', 'lecun'):
            raise ValueError(f'unknown conv init {init!r}')
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.groups, self.init = groups, init
        self.weight = _param((c_out, c_in // groups, kh, kw), device)
        self.bias = _param((c_out,), device, 0.0) if bias else None

    def reset_parameters(self, generator):
        c_out, c_in, kh, kw = self.weight.shape
        fan = kh * kw * (c_out if self.init == 'fan_out' else c_in)
        scale = 2.0 if self.init == 'fan_out' else 1.0
        self.weight.normal_(0.0, math.sqrt(scale / fan), generator=generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv_same(x.to(self.dtype), self.weight.to(self.dtype),
                         self.stride, self.dilation, self.groups, bias)


class WSConv(Conv):
    """Conv with weight standardisation (``WSConv``): the kernel
    standardised per output channel over (in, h, w) in f32 at each
    apply, scaled by ``1/sqrt(fan_in)`` and a learned gain."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1,
                 dilation: int = 1, dtype=torch.bfloat16, device=None,
                 eps: float = 1e-4):
        super().__init__(c_in, c_out, kernel, stride, dilation, dtype, device)
        self.eps = eps
        self.gain = _param((c_out,), device, 1.0)

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        self.gain.data.fill_(1.0)

    def forward(self, x):
        k = self.weight.float()
        var, mean = torch.var_mean(k, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        fan_in = k[0].numel()
        khat = (k - mean) * torch.rsqrt(var * fan_in + self.eps)
        khat = khat * self.gain[:, None, None, None]
        return conv_same(x.to(self.dtype), khat.to(self.dtype), self.stride,
                         self.dilation)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; ``weight``
    is [out, in]."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((d_out, d_in), device)
        self.bias = _param((d_out,), device, 0.0)

    def reset_parameters(self, generator):
        # lecun_normal's scale (the JAX package draws it truncated)
        self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                            generator=generator)
        self.bias.data.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def _channel_rows(x):
    """The [N·H·W, C] rows of an NCHW channels_last activation, as a
    view. On the card a copy would add a pass over the activation the
    kernel exists to save, so there a layout that is not channels_last
    raises; on the CPU it is copied."""
    rows = x.permute(0, 2, 3, 1)
    if not rows.is_contiguous():
        if x.is_cuda:
            raise ValueError(
                f'fused norm takes channels_last activations on the card, '
                f'got strides {x.stride()} for shape {tuple(x.shape)}')
        rows = rows.contiguous()
    return rows.view(-1, x.shape[1])


class _Norm(nn.Module):
    """The batch-norm parameters (``scale``, ``bias``) and flax's running
    statistics (buffers ``mean``, ``var``) shared by both BN variants."""

    def __init__(self, c: int, dtype, device=None, zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.scale = _param((c,), device, 0.0 if zero_scale else 1.0)
        self.bias = _param((c,), device, 0.0)
        self.register_buffer(
            'mean', torch.zeros(c, dtype=torch.float32, device=device))
        self.register_buffer(
            'var', torch.ones(c, dtype=torch.float32, device=device))

    def reset_parameters(self, generator=None):
        self.scale.data.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.mean.mul_(MOMENTUM).add_(mean.detach(), alpha=1.0 - MOMENTUM)
        self.var.mul_(MOMENTUM).add_(var.detach(), alpha=1.0 - MOMENTUM)


class BatchNorm(_Norm):
    """flax ``nn.BatchNorm`` (momentum 0.9, epsilon 1e-5, output in
    ``dtype``): the normalisation through ``F.batch_norm``, the running
    statistics flax's (biased variance)."""

    fuses_act = False

    def forward(self, x, train: bool = False):
        if not train:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                             training=False, eps=EPSILON)
            return y.to(self.dtype)
        c = x.shape[1]
        # momentum 1 into scratch buffers (in the running statistics'
        # dtype): they come back holding the batch mean and the unbiased
        # variance, which is rescaled to the biased one flax keeps
        mean = torch.zeros(c, dtype=self.mean.dtype, device=x.device)
        var = torch.ones(c, dtype=self.mean.dtype, device=x.device)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, training=True,
                         momentum=1.0, eps=EPSILON)
        n = x.numel() // c
        self._update_running(mean, var * ((n - 1) / n))
        return y.to(self.dtype)


class FusedNormAct(_Norm):
    """``FusedNormAct``: the ``BatchNorm`` contract (same parameters and
    statistics) with the following ReLU folded in when ``act``. Train
    mode runs ``ops.fused_norm_act`` (the CUDA kernel for CUDA tensors);
    eval runs the plain version with the running statistics."""

    fuses_act = True

    def __init__(self, c: int, dtype, device=None, zero_scale: bool = False,
                 act: bool = False, impl: str = 'auto'):
        super().__init__(c, dtype, device, zero_scale)
        self.act = act
        self.impl = resolve_norm_impl(impl)

    def forward(self, x, train: bool = False):
        rows = _channel_rows(x)
        if train:
            y, mean, var = fused_norm_act(rows, self.scale, self.bias,
                                          EPSILON, self.act, self.impl)
            self._update_running(mean, var)
        else:
            y, _, _ = reference_norm_act(rows, self.scale, self.bias,
                                         eps=EPSILON, act=self.act,
                                         stats=(self.mean, self.var))
        n, c, h, w = x.shape
        return y.view(n, h, w, c).permute(0, 3, 1, 2).to(self.dtype)


class _Identity(nn.Module):
    def forward(self, x, train: bool = False):
        return x


class _SkipGain(nn.Module):
    """SkipInit: a zero-init per-channel gain at the residual-branch end,
    the norm-free stand-in for BN's zero-init scale."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = _param((c,), device, 0.0)

    def reset_parameters(self, generator=None):
        self.scale.data.zero_()

    def forward(self, x, train: bool = False):
        return x * self.scale.to(x.dtype)[None, :, None, None]


class NormFactory:
    """The norm slot of every block: ``batch``, ``fused`` or ``none``.
    ``fuses_act`` tells blocks that the module applies the ReLU itself."""

    def __init__(self, kind: str, dtype, impl: str = 'auto', device=None):
        if kind not in ('batch', 'fused', 'none'):
            raise ValueError(f'unknown norm variant {kind!r}')
        self.kind, self.dtype, self.impl = kind, dtype, impl
        self.device = device
        self.fuses_act = kind == 'fused'

    def __call__(self, c: int, zero_scale: bool = False, act: bool = False):
        if self.kind == 'batch':
            return BatchNorm(c, self.dtype, self.device, zero_scale)
        if self.kind == 'fused':
            return FusedNormAct(c, self.dtype, self.device, zero_scale,
                                act=act, impl=self.impl)
        # 'none': the zero-scale slot (residual-branch end) becomes
        # SkipInit, every other slot the identity
        return _SkipGain(c, self.device) if zero_scale else _Identity()

    def conv(self, c_in, c_out, kernel, stride=1, dilation=1):
        cls = WSConv if self.kind == 'none' else Conv
        return cls(c_in, c_out, kernel, stride, dilation, self.dtype,
                   self.device)

    @property
    def conv_prefix(self) -> str:
        """flax's auto-name of the block convs (``Conv_i``/``WSConv_i``)."""
        return 'WSConv' if self.kind == 'none' else 'Conv'


class SqueezeExcite(nn.Module):
    """Channel attention: global average → bottleneck MLP → sigmoid
    gate."""

    def __init__(self, c: int, reduction: int = 16, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.fc1 = Dense(c, max(c // reduction, 4), dtype, device)
        self.fc2 = Dense(max(c // reduction, 4), c, dtype, device)

    def forward(self, x):
        s = x.float().mean(dim=(2, 3))
        s = F.relu(self.fc1(s.to(self.fc1.dtype)))
        s = torch.sigmoid(self.fc2(s).float()).to(x.dtype)
        return x * s[:, :, None, None]


def _norm_act(norm, x, train, fuses):
    """A norm slot followed by the ReLU (inside the slot when fused)."""
    x = norm(x, train)
    return x if fuses else F.relu(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, norms: NormFactory,
                 stride: int = 1, se: bool = False, dilation: int = 1):
        super().__init__()
        self.fuses = norms.fuses_act
        conv = norms.conv_prefix
        self.add_module(f'{conv}_0', norms.conv(c_in, filters, 3, stride,
                                                dilation))
        self.BatchNorm_0 = norms(filters, act=True)
        self.add_module(f'{conv}_1', norms.conv(filters, filters, 3, 1,
                                                dilation))
        self.BatchNorm_1 = norms(filters, zero_scale=True)
        self.convs = (f'{conv}_0', f'{conv}_1')
        self.se = SqueezeExcite(filters, dtype=norms.dtype,
                                device=norms.device) if se else None
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.conv_proj = norms.conv(c_in, filters, 1, stride)
            self.norm_proj = norms(filters)

    def forward(self, x, train: bool = False):
        residual = x
        y = getattr(self, self.convs[0])(x)
        y = _norm_act(self.BatchNorm_0, y, train, self.fuses)
        y = getattr(self, self.convs[1])(y)
        y = self.BatchNorm_1(y, train)
        if self.se is not None:
            y = self.se(y)
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(residual), train)
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, norms: NormFactory,
                 stride: int = 1, se: bool = False, dilation: int = 1):
        super().__init__()
        self.fuses = norms.fuses_act
        conv = norms.conv_prefix
        out = filters * 4
        self.add_module(f'{conv}_0', norms.conv(c_in, filters, 1))
        self.BatchNorm_0 = norms(filters, act=True)
        self.add_module(f'{conv}_1', norms.conv(filters, filters, 3, stride,
                                                dilation))
        self.BatchNorm_1 = norms(filters, act=True)
        self.add_module(f'{conv}_2', norms.conv(filters, out, 1))
        self.BatchNorm_2 = norms(out, zero_scale=True)
        self.convs = tuple(f'{conv}_{i}' for i in range(3))
        self.se = SqueezeExcite(out, dtype=norms.dtype,
                                device=norms.device) if se else None
        self.has_proj = stride != 1 or c_in != out
        if self.has_proj:
            self.conv_proj = norms.conv(c_in, out, 1, stride)
            self.norm_proj = norms(out)

    def forward(self, x, train: bool = False):
        residual = x
        y = getattr(self, self.convs[0])(x)
        y = _norm_act(self.BatchNorm_0, y, train, self.fuses)
        y = getattr(self, self.convs[1])(y)
        y = _norm_act(self.BatchNorm_1, y, train, self.fuses)
        y = getattr(self, self.convs[2])(y)
        y = self.BatchNorm_2(y, train)
        if self.se is not None:
            y = self.se(y)
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(residual), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, block, ...)``: ``forward(x)`` takes NHWC
    images [N, H, W, C] of any dtype and returns f32 logits [N, classes];
    ``train=True`` runs the norms on batch statistics and updates the
    running ones."""

    def __init__(self, stage_sizes: Sequence[int], block, num_classes: int = 10,
                 num_filters: int = 64, cifar_stem: bool = True,
                 dtype='bfloat16', norm: str = 'batch',
                 norm_impl: str = 'auto', in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.cifar_stem = cifar_stem
        norms = NormFactory(norm, self.dtype, norm_impl, device)
        self.fuses = norms.fuses_act
        if cifar_stem:
            self.conv_stem = norms.conv(in_channels, num_filters, 3)
        else:
            self.conv_stem = norms.conv(in_channels, num_filters, 7, 2)
        self.norm_stem = norms(num_filters, act=True)
        c = num_filters
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f'{block.__name__}_{len(self.blocks)}'
                self.add_module(name, block(c, num_filters * 2 ** i, norms,
                                            stride))
                self.blocks.append(name)
                c = num_filters * 2 ** i * block.expansion
        self.head = Dense(c, num_classes, torch.float32, device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX initialisers' distributions (``init_parameters``)."""
        init_parameters(self, generator)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits [N, num_classes] f32 of NHWC images ``x``. ``generator``
        is accepted for the train step's sake (no dropout here)."""
        x = self.conv_stem(to_nchw(x, self.dtype))
        x = _norm_act(self.norm_stem, x, train, self.fuses)
        if not self.cifar_stem:
            x = max_pool_same(x)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)


_VARIANTS = {
    'resnet18': ([2, 2, 2, 2], BasicBlock),
    'resnet34': ([3, 4, 6, 3], BasicBlock),
    'resnet50': ([3, 4, 6, 3], Bottleneck),
    'resnet101': ([3, 4, 23, 3], Bottleneck),
    'resnet152': ([3, 8, 36, 3], Bottleneck),
}


def _factory(sizes, block, num_classes=10, cifar_stem=True, dtype='bfloat16',
             num_filters=64, norm='batch', norm_impl='auto', input_shape=None,
             mesh=None, device=None, generator=None, **_):
    """The JAX factory's keys; ``input_shape`` (NHWC without the batch,
    as an export records it) gives the input channels, 3 by default."""
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh is not ported yet (ROADMAP.md, queue A: A4)')
    in_channels = int(input_shape[-1]) if input_shape else 3
    return ResNet(sizes, block, num_classes=num_classes,
                  num_filters=int(num_filters), cifar_stem=cifar_stem,
                  dtype=dtype, norm=norm, norm_impl=norm_impl,
                  in_channels=in_channels, device=device, generator=generator)


for _name, (_sizes, _block) in _VARIANTS.items():
    register_model(_name)(partial(_factory, _sizes, _block))


__all__ = ['ResNet', 'BasicBlock', 'Bottleneck', 'Conv', 'WSConv', 'Dense',
           'BatchNorm', 'FusedNormAct', 'NormFactory', 'SqueezeExcite',
           'same_pads', 'conv_same', 'max_pool_same', 'max_pool_valid',
           'avg_pool_valid', 'to_nchw', 'init_parameters']

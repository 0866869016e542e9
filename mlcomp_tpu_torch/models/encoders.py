"""Encoder families — port of ``mlcomp_tpu/models/encoders.py``: VGG,
DenseNet, SE-ResNet, EfficientNet-lite / MobileNetV2, DRN, Xception, DPN
and Inception-ResNet-v2, each returning the pyramid [c1..c5] of an NCHW
(channels_last) input already in ``dtype``, with ``channels`` listing
their widths, so every family plugs into every decoder of
``models/segmentation.py`` and into ``EncoderClassifier``, the GAP +
linear head registered under each family's name.

JAX decides some branches from shapes at trace time (a block projects
its skip where ``skip.shape != y.shape``); the port decides them when
the module is built, from the same channel and stride arithmetic.
Depthwise and grouped convs are ``Conv(groups=...)``; ReLU6 is
``F.relu6``. Concatenations run over NCHW's dim 1 in JAX's order.
Module names are the flax paths (``s{i}_conv{j}``, ``b{bi}_{li}_norm1``,
``sep{i}``, ...), so ``convert.image_state_dict_from_jax`` carries the
weights both ways.
"""

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models.base import register_model
from mlcomp_tpu_torch.models.resnet import (
    BasicBlock, BatchNorm, Bottleneck, Conv, Dense, avg_pool_valid,
    init_parameters, max_pool_same, max_pool_valid, to_nchw,
)
from mlcomp_tpu_torch.models.transformer import torch_dtype


class _Family(nn.Module):
    """The conv and norm constructors every family shares (the zoo's
    ``conv_partial`` / ``norm_partial``: no bias, fan-out init;
    ``nn.BatchNorm`` with momentum 0.9)."""

    def __init__(self, dtype, device):
        super().__init__()
        self._conv_args = {'dtype': dtype, 'device': device}

    def add_conv(self, name, c_in, c_out, kernel, stride=1, groups=1):
        self.add_module(name, Conv(c_in, c_out, kernel, stride,
                                   groups=groups, **self._conv_args))

    def add_norm(self, name, c, zero_scale=False):
        self.add_module(name, BatchNorm(c, self._conv_args['dtype'],
                                        self._conv_args['device'],
                                        zero_scale))

    def apply_norm(self, name, x, train, act=F.relu):
        x = getattr(self, name)(x, train)
        return act(x) if act is not None else x


# ------------------------------------------------------------------- VGG
class VGGEncoder(_Family):
    """VGG-BN trunk: stage i's output is captured before the next 2x2
    (VALID) max-pool, so [c1..c5] sit at strides 1, 2, 4, 8, 16.
    ``cifar_stem`` is accepted and unused, as in JAX."""

    def __init__(self, stage_sizes: Sequence[int],
                 channels: Sequence[int] = (64, 128, 256, 512, 512),
                 dtype=torch.bfloat16, cifar_stem: bool = False,
                 in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.stage_sizes = list(stage_sizes)
        c = in_channels
        self.channels = []
        for i, (n, ch) in enumerate(zip(self.stage_sizes, channels)):
            for j in range(n):
                self.add_conv(f's{i}_conv{j}', c, ch, 3)
                self.add_norm(f's{i}_norm{j}', ch)
                c = ch
            self.channels.append(c)

    def forward(self, x, train: bool = False):
        features = []
        for i, n in enumerate(self.stage_sizes):
            if i > 0:
                x = max_pool_valid(x)
            for j in range(n):
                x = self.apply_norm(f's{i}_norm{j}',
                                    getattr(self, f's{i}_conv{j}')(x), train)
            features.append(x)
        return features


# -------------------------------------------------------------- DenseNet
class DenseNetEncoder(_Family):
    """DenseNet trunk: dense blocks joined by 1x1 + 2x2 average-pool
    transitions; [c1..c5] = the stem, then each dense block's output (the
    last after ``norm_final``)."""

    def __init__(self, block_sizes: Sequence[int], growth: int = 32,
                 init_features: int = 64, dtype=torch.bfloat16,
                 cifar_stem: bool = False, in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.block_sizes = list(block_sizes)
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.add_conv('conv_stem', in_channels, init_features, 3)
        else:
            self.add_conv('conv_stem', in_channels, init_features, 7, 2)
        self.add_norm('norm_stem', init_features)
        c = init_features
        self.channels = [c]
        for bi, n_layers in enumerate(self.block_sizes):
            if bi > 0:
                self.add_norm(f't{bi}_norm', c)
                self.add_conv(f't{bi}_conv', c, c // 2, 1)
                c //= 2
            for li in range(n_layers):
                pre = f'b{bi}_{li}'
                self.add_norm(f'{pre}_norm1', c)
                self.add_conv(f'{pre}_conv1', c, 4 * growth, 1)
                self.add_norm(f'{pre}_norm2', 4 * growth)
                self.add_conv(f'{pre}_conv2', 4 * growth, growth, 3)
                c += growth
            if bi == len(self.block_sizes) - 1:
                self.add_norm('norm_final', c)
            self.channels.append(c)

    def forward(self, x, train: bool = False):
        x = self.apply_norm('norm_stem', self.conv_stem(x), train)
        features = [x]
        if not self.cifar_stem:
            x = max_pool_same(x)
        for bi, n_layers in enumerate(self.block_sizes):
            if bi > 0:
                x = self.apply_norm(f't{bi}_norm', x, train)
                x = avg_pool_valid(getattr(self, f't{bi}_conv')(x), 2)
            for li in range(n_layers):
                pre = f'b{bi}_{li}'
                y = self.apply_norm(f'{pre}_norm1', x, train)
                y = getattr(self, f'{pre}_conv1')(y)
                y = self.apply_norm(f'{pre}_norm2', y, train)
                y = getattr(self, f'{pre}_conv2')(y)
                x = torch.cat([x, y], dim=1)
            if bi == len(self.block_sizes) - 1:
                x = self.apply_norm('norm_final', x, train)
            features.append(x)
        return features


# ------------------------------------------------------------- SE-ResNet
# the shared ResNet blocks with squeeze-excite; a partial of BasicBlock,
# so flax (and the port) still names it BasicBlock_i
SEBasicBlock = partial(BasicBlock, se=True)
SEBottleneck = partial(Bottleneck, se=True)


# ---------------------------------------------------------- EfficientNet
class MBConv(_Family):
    """Inverted residual (lite: no SE, ReLU6). ``project_norm`` starts at
    zero scale only where the residual add happens."""

    def __init__(self, c_in: int, filters: int, expand: int, kernel: int,
                 stride: int = 1, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.expand_ratio = expand
        mid = c_in * expand
        if expand != 1:
            self.add_conv('expand', c_in, mid, 1)
            self.add_norm('expand_norm', mid)
        self.add_conv('depthwise', mid, mid, kernel, stride, groups=mid)
        self.add_norm('depthwise_norm', mid)
        self.add_conv('project', mid, filters, 1)
        self.has_skip = stride == 1 and c_in == filters
        self.add_norm('project_norm', filters, zero_scale=self.has_skip)

    def forward(self, x, train: bool = False):
        y = x
        if self.expand_ratio != 1:
            y = self.apply_norm('expand_norm', self.expand(y), train, F.relu6)
        y = self.apply_norm('depthwise_norm', self.depthwise(y), train,
                            F.relu6)
        y = self.apply_norm('project_norm', self.project(y), train, None)
        return y + x if self.has_skip else y


# (expand, channels, repeats, stride, kernel) — efficientnet-lite0
_EFFNET_LITE0 = (
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# MobileNetV2's stage table: the same MBConv trunk
_MOBILENET_V2 = (
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 32, 3, 2, 3),
    (6, 64, 4, 2, 3), (6, 96, 3, 1, 3), (6, 160, 3, 2, 3),
    (6, 320, 1, 1, 3),
)


class EfficientNetEncoder(_Family):
    """A stage table of MBConvs. The finest map of each stride level is
    captured before the block that halves it, the last block's output
    closes the list, and the pyramid is padded to five levels by
    repeating its first entry."""

    def __init__(self, stages: Sequence[Tuple[int, int, int, int, int]]
                 = _EFFNET_LITE0, stem_features: int = 32,
                 dtype=torch.bfloat16, cifar_stem: bool = False,
                 in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.add_conv('conv_stem', in_channels, stem_features, 3,
                  1 if cifar_stem else 2)
        self.add_norm('norm_stem', stem_features)
        c = stem_features
        self.blocks = []           # (name, capture the input first)
        channels = []
        for si, (expand, ch, repeats, stride, kernel) in enumerate(stages):
            for ri in range(repeats):
                s = stride if ri == 0 else 1
                if s == 2:
                    channels.append(c)
                name = f's{si}_b{ri}'
                self.add_module(name, MBConv(c, ch, expand, kernel, s,
                                             **self._conv_args))
                self.blocks.append((name, s == 2))
                c = ch
        channels.append(c)
        self.channels = _five_levels(channels)

    def forward(self, x, train: bool = False):
        x = self.apply_norm('norm_stem', self.conv_stem(x), train, F.relu6)
        features = []
        for name, capture in self.blocks:
            if capture:
                features.append(x)
            x = getattr(self, name)(x, train)
        features.append(x)
        return _five_levels(features)


def _five_levels(features: list) -> list:
    """JAX's pyramid contract: pad to five levels by repeating the first,
    keep the last five."""
    features = list(features)
    while len(features) < 5:
        features.insert(0, features[0])
    return features[-5:]


# -------------------------------------------------------------- Xception
class SeparableConv(_Family):
    """Depthwise 3x3 + pointwise 1x1 + norm; ``zero_scale`` starts the
    norm's scale at zero (a residual branch's end)."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 zero_scale: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.add_conv('depthwise', c_in, c_in, 3, stride, groups=c_in)
        self.add_conv('pointwise', c_in, features, 1)
        self.add_norm('norm', features, zero_scale)

    def forward(self, x, train: bool = False):
        return self.norm(self.pointwise(self.depthwise(x)), train)


class XceptionBlock(_Family):
    """``reps`` separable convs, the last with the block's stride, and a
    1x1-projected skip where the shapes differ."""

    def __init__(self, c_in: int, features: int, reps: int, stride: int = 1,
                 start_with_relu: bool = True, dtype=torch.bfloat16,
                 device=None):
        super().__init__(dtype, device)
        self.reps, self.start_with_relu = reps, start_with_relu
        c = c_in
        for i in range(reps):
            self.add_module(f'sep{i}', SeparableConv(
                c, features, stride if i == reps - 1 else 1,
                zero_scale=i == reps - 1, **self._conv_args))
            c = features
        self.has_skip_conv = stride != 1 or c_in != features
        if self.has_skip_conv:
            self.add_conv('conv_skip', c_in, features, 1, stride)
            self.add_norm('norm_skip', features)

    def forward(self, x, train: bool = False):
        y = x
        for i in range(self.reps):
            if i > 0 or self.start_with_relu:
                y = F.relu(y)
            y = getattr(self, f'sep{i}')(y, train)
        skip = x
        if self.has_skip_conv:
            skip = self.apply_norm('norm_skip', self.conv_skip(x), train, None)
        return y + skip


class XceptionEncoder(_Family):
    """Aligned-Xception trunk: stem, entry flow (three strided blocks),
    ``middle_reps`` residual blocks, exit flow."""

    def __init__(self, middle_reps: int = 8, dtype=torch.bfloat16,
                 cifar_stem: bool = False, in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.middle_reps = middle_reps
        self.add_conv('conv_stem1', in_channels, 32, 3, 1 if cifar_stem else 2)
        self.add_norm('norm_stem1', 32)
        self.add_conv('conv_stem2', 32, 64, 3)
        self.add_norm('norm_stem2', 64)
        block = partial(XceptionBlock, **self._conv_args)
        self.entry1 = block(64, 128, 2, stride=2, start_with_relu=False)
        self.entry2 = block(128, 256, 2, stride=2)
        self.entry3 = block(256, 728, 2, stride=2)
        for i in range(middle_reps):
            self.add_module(f'middle{i}', block(728, 728, 3))
        self.exit = block(728, 1024, 2, stride=2)
        self.exit_sep1 = SeparableConv(1024, 1536, **self._conv_args)
        self.exit_sep2 = SeparableConv(1536, 2048, **self._conv_args)
        self.channels = [64, 128, 256, 728, 2048]

    def forward(self, x, train: bool = False):
        x = self.apply_norm('norm_stem1', self.conv_stem1(x), train)
        x = self.apply_norm('norm_stem2', self.conv_stem2(x), train)
        features = [x]
        x = self.entry1(x, train)
        features.append(x)
        x = self.entry2(x, train)
        features.append(x)
        x = self.entry3(x, train)
        for i in range(self.middle_reps):
            x = getattr(self, f'middle{i}')(x, train)
        features.append(x)
        x = self.exit(x, train)
        x = F.relu(self.exit_sep1(x, train))
        x = F.relu(self.exit_sep2(x, train))
        features.append(x)
        return features


# ------------------------------------------------------------------- DPN
class DPNBlock(_Family):
    """Dual-path block: a grouped bottleneck over the joined (residual ++
    dense) paths whose output splits into a residual part (added) and a
    dense part (concatenated). Where the residual's shape changes (a
    stage boundary) the joined paths are projected to the new residual
    base and the dense path restarts. ``dense_in`` is None before the
    first block."""

    def __init__(self, res_in: int, dense_in: Optional[int], res_ch: int,
                 inc_ch: int, groups: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.res_ch = res_ch
        joined = res_in + (dense_in or 0)
        mid = res_ch // 2
        self.add_norm('norm_in', joined)
        self.add_conv('conv_a', joined, mid, 1)
        self.add_norm('norm_a', mid)
        self.add_conv('conv_b', mid, mid, 3, stride, groups=groups)
        self.add_norm('norm_b', mid)
        self.add_conv('conv_c', mid, res_ch + inc_ch, 1)
        self.project = stride != 1 or res_in != res_ch
        if self.project:
            self.add_conv('conv_proj', joined, res_ch, 1, stride)
        self.dense_out = inc_ch if self.project or dense_in is None \
            else dense_in + inc_ch

    def forward(self, res, dense, train: bool = False):
        joined = torch.cat([res, dense], dim=1) if dense is not None else res
        y = self.apply_norm('norm_in', joined, train)
        y = self.apply_norm('norm_a', self.conv_a(y), train)
        y = self.apply_norm('norm_b', self.conv_b(y), train)
        out = self.conv_c(y)
        res_out, inc = out[:, :self.res_ch], out[:, self.res_ch:]
        if self.project:
            res = self.conv_proj(joined)
            dense = None
        new_dense = inc if dense is None else torch.cat([dense, inc], dim=1)
        return res + res_out, new_dense


class DPNEncoder(_Family):
    """DPN trunk (dpn68-like): four stages of dual-path blocks; each
    feature is the fused (residual ++ dense) map, the last after
    ``norm_final``."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 12, 3),
                 stage_res: Sequence[int] = (64, 128, 256, 512),
                 stage_inc: Sequence[int] = (16, 32, 32, 64),
                 groups: int = 32, dtype=torch.bfloat16,
                 cifar_stem: bool = False, in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.add_conv('conv_stem', in_channels, 64, 3)
        else:
            self.add_conv('conv_stem', in_channels, 64, 7, 2)
        self.add_norm('norm_stem', 64)
        self.channels = [64]
        self.stages = []
        res, dense = 64, None
        for si, (n, rc, ic) in enumerate(zip(stage_blocks, stage_res,
                                             stage_inc)):
            names = []
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                block = DPNBlock(res, dense, rc, ic, groups, stride,
                                 **self._conv_args)
                self.add_module(f's{si}_b{bi}', block)
                names.append(f's{si}_b{bi}')
                res, dense = rc, block.dense_out
            self.stages.append(names)
            self.channels.append(res + dense)
        self.add_norm('norm_final', self.channels[-1])

    def forward(self, x, train: bool = False):
        x = self.apply_norm('norm_stem', self.conv_stem(x), train)
        features = [x]
        if not self.cifar_stem:
            x = max_pool_same(x)
        res, dense = x, None
        for si, names in enumerate(self.stages):
            for name in names:
                res, dense = getattr(self, name)(res, dense, train)
            fused = torch.cat([res, dense], dim=1)
            if si == len(self.stages) - 1:
                fused = self.apply_norm('norm_final', fused, train)
            features.append(fused)
        return features


# ---------------------------------------------------- Inception-ResNet-v2
class InceptionResnetBlock(_Family):
    """Residual inception block: parallel conv-norm-ReLU branches,
    concatenated, a 1x1 back to the trunk width (``norm_project`` starts
    at zero scale), ``relu(x + scale * y)``."""

    def __init__(self, c: int, branches, scale: float = 0.17,
                 dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.scale = scale
        self.branches = [len(branch) for branch in branches]
        cat = 0
        for bi, branch in enumerate(branches):
            c_in = c
            for li, (ch, kernel) in enumerate(branch):
                self.add_conv(f'b{bi}_conv{li}', c_in, ch, kernel)
                self.add_norm(f'b{bi}_norm{li}', ch)
                c_in = ch
            cat += c_in
        self.add_conv('project', cat, c, 1)
        self.add_norm('norm_project', c, zero_scale=True)

    def forward(self, x, train: bool = False):
        outs = []
        for bi, n in enumerate(self.branches):
            y = x
            for li in range(n):
                y = getattr(self, f'b{bi}_conv{li}')(y)
                y = self.apply_norm(f'b{bi}_norm{li}', y, train)
            outs.append(y)
        y = self.project(torch.cat(outs, dim=1))
        y = self.apply_norm('norm_project', y, train, None)
        return F.relu(x + self.scale * y)


_BLOCK35 = [[(32, (1, 1))],
            [(32, (1, 1)), (32, (3, 3))],
            [(32, (1, 1)), (48, (3, 3)), (64, (3, 3))]]
_BLOCK17 = [[(192, (1, 1))],
            [(128, (1, 1)), (160, (1, 7)), (192, (7, 1))]]
_BLOCK8 = [[(192, (1, 1))],
           [(192, (1, 1)), (224, (1, 3)), (256, (3, 1))]]


class InceptionResNetV2Encoder(_Family):
    """Inception-ResNet-v2 trunk: conv stem, then 35/17/8-style
    residual-inception stages joined by strided reductions."""

    def __init__(self, repeats: Sequence[int] = (10, 20, 10),
                 dtype=torch.bfloat16, cifar_stem: bool = False,
                 in_channels: int = 3, device=None):
        super().__init__(dtype, device)
        self.repeats = list(repeats)
        self.cifar_stem = cifar_stem
        for name, c_in, c_out, kernel, stride in (
                ('stem1', in_channels, 32, 3, 1 if cifar_stem else 2),
                ('stem2', 32, 32, 3, 1), ('stem3', 32, 64, 3, 1),
                ('stem4', 64, 80, 1, 1), ('stem5', 80, 192, 3, 1),
                ('mixed5b', 192, 320, 1, 1),
                ('reduction_a', 320, 1088, 3, 2),
                ('reduction_b', 1088, 2080, 3, 2),
                ('conv_final', 2080, 1536, 1, 1)):
            self.add_conv(f'{name}_conv', c_in, c_out, kernel, stride)
            self.add_norm(f'{name}_norm', c_out)
        block = partial(InceptionResnetBlock, **self._conv_args)
        for i in range(self.repeats[0]):
            self.add_module(f'block35_{i}', block(320, _BLOCK35, 0.17))
        for i in range(self.repeats[1]):
            self.add_module(f'block17_{i}', block(1088, _BLOCK17, 0.10))
        for i in range(self.repeats[2]):
            self.add_module(f'block8_{i}', block(2080, _BLOCK8, 0.20))
        self.channels = [64, 192, 320, 1088, 1536]

    def cna(self, name, x, train):
        return self.apply_norm(f'{name}_norm',
                               getattr(self, f'{name}_conv')(x), train)

    def _blocks(self, prefix, n, x, train):
        for i in range(n):
            x = getattr(self, f'{prefix}_{i}')(x, train)
        return x

    def forward(self, x, train: bool = False):
        for name in ('stem1', 'stem2', 'stem3'):
            x = self.cna(name, x, train)
        features = [x]
        if not self.cifar_stem:
            x = max_pool_same(x)
        x = self.cna('stem5', self.cna('stem4', x, train), train)
        features.append(x)
        x = self.cna('mixed5b', max_pool_same(x), train)
        x = self._blocks('block35', self.repeats[0], x, train)
        features.append(x)
        x = self.cna('reduction_a', x, train)
        x = self._blocks('block17', self.repeats[1], x, train)
        features.append(x)
        x = self.cna('reduction_b', x, train)
        x = self._blocks('block8', self.repeats[2], x, train)
        features.append(self.cna('conv_final', x, train))
        return features


# ------------------------------------------------- registry + classifier
def _resnet_encoder(sizes, block, **kwargs):
    from mlcomp_tpu_torch.models.segmentation import ResNetEncoder
    return ResNetEncoder(sizes, block, **kwargs)


#: name -> factory(dtype=, cifar_stem=, in_channels=, device=)
ENCODER_FACTORIES = {
    'vgg13': partial(VGGEncoder, (2, 2, 2, 2, 2)),
    'vgg16': partial(VGGEncoder, (2, 2, 3, 3, 3)),
    'densenet121': partial(DenseNetEncoder, (6, 12, 24, 16)),
    'densenet169': partial(DenseNetEncoder, (6, 12, 32, 32)),
    'seresnet18': partial(_resnet_encoder, [2, 2, 2, 2], SEBasicBlock),
    'seresnet34': partial(_resnet_encoder, [3, 4, 6, 3], SEBasicBlock),
    'seresnet50': partial(_resnet_encoder, [3, 4, 6, 3], SEBottleneck),
    'efficientnet_lite0': EfficientNetEncoder,
    'mobilenetv2': partial(EfficientNetEncoder, _MOBILENET_V2, 32),
    # DRN-C-26-shaped: stages 3/4 trade stride for dilation (2, 4), so
    # c4/c5 stay at c3's resolution (built for DeepLabV3)
    'drn26': partial(_resnet_encoder, [2, 2, 2, 2], BasicBlock,
                     stage_dilations=(1, 1, 2, 4)),
    'xception': XceptionEncoder,
    'dpn68': DPNEncoder,
    'inceptionresnetv2': InceptionResNetV2Encoder,
}


def make_family_encoder(name: str, dtype, cifar_stem: bool = False,
                        in_channels: int = 3, device=None):
    """The encoder module of any registered family (the ResNets
    included)."""
    kwargs = {'dtype': dtype, 'cifar_stem': cifar_stem,
              'in_channels': in_channels, 'device': device}
    if name in ENCODER_FACTORIES:
        return ENCODER_FACTORIES[name](**kwargs)
    from mlcomp_tpu_torch.models.segmentation import _ENCODERS
    if name in _ENCODERS:
        return _resnet_encoder(*_ENCODERS[name], **kwargs)
    raise ValueError(f'unknown encoder {name!r}; have '
                     f'{sorted(ENCODER_FACTORIES) + sorted(_ENCODERS)}')


class EncoderClassifier(nn.Module):
    """Any pyramid encoder + global average pool (in the compute dtype) +
    an f32 linear ``head``: NHWC images in, f32 logits out."""

    def __init__(self, encoder: str = 'vgg16', num_classes: int = 10,
                 dtype='bfloat16', cifar_stem: bool = False,
                 in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        enc = make_family_encoder(encoder, self.dtype, cifar_stem,
                                  in_channels, device)
        self.encoder_key = f'{type(enc).__name__}_0'
        self.add_module(self.encoder_key, enc)
        self.head = Dense(enc.channels[-1], num_classes, torch.float32, device)
        init_parameters(self, generator)

    def forward(self, x, train: bool = False, generator=None):
        feats = getattr(self, self.encoder_key)(to_nchw(x, self.dtype), train)
        x = feats[-1].float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)


def _classifier_factory(encoder, num_classes=10, cifar_stem=False,
                        dtype='bfloat16', input_shape=None, mesh=None,
                        device=None, generator=None, **_):
    """JAX's factory keys (unknown ones such as ``norm`` are dropped, as
    JAX's ``**_`` drops them); ``input_shape`` gives the channels."""
    if mesh is not None:
        raise NotImplementedError(
            'a device mesh is not ported yet (ROADMAP.md, queue A: A4)')
    return EncoderClassifier(
        encoder, num_classes, dtype, bool(cifar_stem),
        in_channels=int(input_shape[-1]) if input_shape else 3,
        device=device, generator=generator)


for _enc in ENCODER_FACTORIES:
    register_model(_enc)(partial(_classifier_factory, _enc))


__all__ = ['VGGEncoder', 'DenseNetEncoder', 'SEBasicBlock', 'SEBottleneck',
           'MBConv', 'EfficientNetEncoder', 'SeparableConv', 'XceptionBlock',
           'XceptionEncoder', 'DPNBlock', 'DPNEncoder',
           'InceptionResnetBlock', 'InceptionResNetV2Encoder',
           'EncoderClassifier', 'ENCODER_FACTORIES', 'make_family_encoder']

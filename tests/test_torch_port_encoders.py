"""The port's model zoo against the JAX package's, on the CPU: every
registered name's parameter tree, and each encoder family's numbers.

- For each of the port's 111 names (the JAX registry's but
  ``pipelined_lm``), ``jax.eval_shape`` of the JAX model's ``init`` at
  full width, carried through the converter, gives the port model's
  ``state_dict`` keys and shapes exactly: a wrong name or a
  shape-driven branch (a projected skip, a zero-init norm's place)
  taken where JAX does not take it fails here without computing
  anything.
- Each family, its depth cut (widths narrowed where the family
  allows), from the same random weights and statistics on both sides:
  the pyramid [c1..c5] in eval and in train mode, the new running
  statistics, and the gradients of a scalar of the train-mode pyramid,
  each within a stated share of the row's largest magnitude (a row is
  an example of an activation, an output channel of a kernel, a whole
  vector). JAX is the oracle in f64 (``jax_reference`` says why); the
  port runs in f32 and again in f64. Inputs are 32x32 with
  ``cifar_stem``, 64x64 and 62x62 without (odd dims after the first
  halving, where flax's asymmetric 'SAME' pads and VALID pools meet
  them).
"""

from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.models import encoders as jax_encoders
from mlcomp_tpu.models import model_names as jax_model_names
from mlcomp_tpu.models import segmentation as jax_segmentation
from mlcomp_tpu.models import resnet as jax_resnet
from mlcomp_tpu.models.resnet import BasicBlock as JaxBasicBlock
from mlcomp_tpu_torch.convert import (
    image_state_dict_from_jax, input_shape_from_params, state_dict_from_jax,
)
from mlcomp_tpu_torch.models import create_model, model_names, param_count
from mlcomp_tpu_torch.models import encoders as port_encoders
from mlcomp_tpu_torch.models import segmentation as port_segmentation
from mlcomp_tpu_torch.models.resnet import BasicBlock, Conv, to_nchw

#: f32 on both sides: the same math, summed in another order
ROW_TOL = 1e-5

PORT_NAMES = sorted(set(jax_model_names()) - {'pipelined_lm'})


def assert_rows_close(got, want, tol=ROW_TOL, what='', floor=0.0):
    """Each row's largest error within ``tol`` of the row's largest
    magnitude, or of ``floor`` where that is larger (a row that is zero
    in exact arithmetic holds rounding noise alone); a 0-d or 1-d array
    is one row."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g = got.reshape(got.shape[0], -1) if got.ndim > 1 else got.reshape(1, -1)
    w = want.reshape(g.shape)
    err = np.abs(g - w).max(1)
    scale = np.maximum(np.abs(w).max(1), floor)
    bad = np.flatnonzero(~(err <= tol * scale))
    worst = (err[bad] / np.maximum(scale[bad], 1e-300)).max() \
        if len(bad) else 0.0
    assert not len(bad), (f'{what}: rows {bad[:5].tolist()} off by '
                          f'{worst} of their largest magnitude')


# ------------------------------------------------------------- key sets
def _jax_input(name):
    if name == 'transformer_lm':
        return jnp.zeros((1, 16), jnp.int32)
    if name == 'mlp':
        return jnp.zeros((1, 8, 8, 1), jnp.float32)
    if name == 'vit':           # its default image_size
        return jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jnp.zeros((1, 64, 64, 3), jnp.float32)


@pytest.mark.parametrize('name', PORT_NAMES)
def test_state_dict_keys_and_shapes_are_jax_s(name):
    kwargs = {'num_classes': 10} if name == 'vit' else {}
    model = jax_create_model(name, **kwargs)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), _jax_input(name), train=False))
    variables = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                             nn.meta.unbox(shapes))
    want = state_dict_from_jax(variables, name)
    params = variables['params']
    port = create_model(name, **kwargs, device='cpu', input_shape=(
        input_shape_from_params(name, params)))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert param_count(port) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(params))


@pytest.mark.parametrize('name', ['vgg13', 'xception', 'inceptionresnetv2',
                                  'seresnet18', 'fpn_densenet121',
                                  'unet_vgg16', 'unet'])
def test_input_shape_from_params_reads_each_family_s_first_conv(name):
    """An export without ``input_shape`` rebuilds from its first conv:
    ``s0_conv0``, ``conv_stem1``, ``stem1_conv``, ``conv_stem`` (inside
    ``{Family}Encoder_0`` for classifiers and decoders), ``down_0``."""
    model = jax_create_model(name)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                          nn.meta.unbox(shapes))['params']
    assert input_shape_from_params(name, params) == (None, None, 1)


def test_registry_is_jax_s_without_pipelined_lm():
    assert model_names() == PORT_NAMES
    assert len(PORT_NAMES) == 111
    with pytest.raises(KeyError, match='not ported'):
        create_model('pipelined_lm')


@pytest.mark.parametrize('name,count', [
    ('seresnet18', 11_263_042), ('vgg13', 9_413_066),
    ('densenet121', 6_956_426), ('efficientnet_lite0', 2_962_058),
    ('inceptionresnetv2', 71_122_570)])
def test_full_width_parameter_counts(name, count):
    """The counts ``chip_smoke.py``'s ``[zoo]`` holds the card's models
    to (it cannot import JAX)."""
    model = jax_create_model(name, num_classes=10, cifar_stem=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        nn.meta.unbox(shapes)['params'])) == count
    assert param_count(create_model(name, num_classes=10, cifar_stem=True,
                                    device='cpu')) == count


def test_family_factory_refuses_unknown_encoder_as_jax_does():
    with pytest.raises(ValueError) as want:
        jax_encoders.make_family_encoder('nope', jnp.float32)
    with pytest.raises(ValueError) as got:
        port_encoders.make_family_encoder('nope', torch.float32)
    assert str(got.value) == str(want.value)


def test_classifier_factory_drops_unknown_keys_as_jax_does():
    model = create_model('vgg13', num_classes=3, norm='fused', depth=7,
                         device='cpu')
    assert model.head.weight.shape[0] == 3


# ------------------------------------------------------ family numbers
_EFF_TWO = ((1, 8, 1, 1, 3), (6, 16, 2, 2, 5))
#: DPN narrowed; stage 0 keeps the stem's 64 channels, so its first
#: block adds its residual unprojected as at full width
_DPN_NARROW = {'stage_res': (64, 32, 32, 32), 'stage_inc': (8, 8, 8, 8),
               'groups': 8}


class _JaxXceptionBlocks(nn.Module):
    """Xception's parts at narrow widths: a strided entry block without
    the leading ReLU, a middle block (identity skip), a strided exit
    block and a separable conv, each output a feature. (The whole
    encoder's 728-channel depthwise convs are slow in XLA's f64; it is
    held in f32 eval mode below.)"""
    dtype: object = jnp.float64

    @nn.compact
    def __call__(self, x, train: bool = False):
        conv = jax_resnet.conv_partial(self.dtype)
        norm = jax_resnet.norm_partial(self.dtype, train)
        block = partial(jax_encoders.XceptionBlock, conv=conv, norm=norm)
        x = conv(8, (3, 3), name='conv_stem')(x.astype(self.dtype))
        feats = []
        x = block(16, 2, stride=2, start_with_relu=False, name='entry1')(x)
        feats.append(x)
        x = block(16, 3, name='middle0')(x)
        feats.append(x)
        x = block(24, 2, stride=2, name='exit')(x)
        feats.append(x)
        feats.append(nn.relu(jax_encoders.SeparableConv(
            32, conv=conv, norm=norm, name='exit_sep1')(x)))
        return feats


class _PortXceptionBlocks(torch.nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv_stem = Conv(3, 8, 3, dtype=dtype)
        self.entry1 = port_encoders.XceptionBlock(
            8, 16, 2, stride=2, start_with_relu=False, dtype=dtype)
        self.middle0 = port_encoders.XceptionBlock(16, 16, 3, dtype=dtype)
        self.exit = port_encoders.XceptionBlock(16, 24, 2, stride=2,
                                                dtype=dtype)
        self.exit_sep1 = port_encoders.SeparableConv(24, 32, dtype=dtype)
        self.channels = [16, 16, 24, 32]

    def forward(self, x, train=False):
        x = self.conv_stem(x)
        feats = []
        for block in (self.entry1, self.middle0, self.exit):
            x = block(x, train)
            feats.append(x)
        feats.append(torch.nn.functional.relu(self.exit_sep1(x, train)))
        return feats



#: family -> (JAX encoder(cifar_stem, dtype), port encoder(cifar_stem)),
#: depth cut
FAMILIES = {
    'vgg': (
        lambda cs, dt: jax_encoders.VGGEncoder(
            stage_sizes=(2, 2, 2, 2, 2), channels=(8, 16, 16, 32, 32),
            dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.VGGEncoder(
            (2, 2, 2, 2, 2), channels=(8, 16, 16, 32, 32),
            dtype=torch.float32, cifar_stem=cs)),
    'densenet': (
        lambda cs, dt: jax_encoders.DenseNetEncoder(
            block_sizes=(1, 2, 1, 1), growth=8, init_features=16,
            dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.DenseNetEncoder(
            (1, 2, 1, 1), growth=8, init_features=16, dtype=torch.float32,
            cifar_stem=cs)),
    'efficientnet': (
        lambda cs, dt: jax_encoders.EfficientNetEncoder(
            stages=_EFF_TWO, stem_features=8, dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.EfficientNetEncoder(
            _EFF_TWO, stem_features=8, dtype=torch.float32, cifar_stem=cs)),
    'xception_blocks': (
        lambda cs, dt: _JaxXceptionBlocks(dtype=dt),
        lambda cs: _PortXceptionBlocks()),
    'inceptionresnet': (
        lambda cs, dt: jax_encoders.InceptionResNetV2Encoder(
            repeats=(1, 1, 1), dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.InceptionResNetV2Encoder(
            repeats=(1, 1, 1), dtype=torch.float32, cifar_stem=cs)),
    'dpn': (
        lambda cs, dt: jax_encoders.DPNEncoder(
            stage_blocks=(1, 2, 1, 1), **_DPN_NARROW, dtype=dt,
            cifar_stem=cs),
        lambda cs: port_encoders.DPNEncoder(
            stage_blocks=(1, 2, 1, 1), **_DPN_NARROW, dtype=torch.float32,
            cifar_stem=cs)),
    'seresnet_basic': (
        lambda cs, dt: jax_segmentation.ResNetEncoder(
            stage_sizes=[2, 1, 1, 1], block=jax_encoders.SEBasicBlock,
            num_filters=8, dtype=dt, cifar_stem=cs),
        lambda cs: port_segmentation.ResNetEncoder(
            [2, 1, 1, 1], port_encoders.SEBasicBlock, num_filters=8,
            dtype=torch.float32, cifar_stem=cs)),
    'seresnet_bottleneck': (
        lambda cs, dt: jax_segmentation.ResNetEncoder(
            stage_sizes=[1, 1, 1, 1], block=jax_encoders.SEBottleneck,
            num_filters=8, dtype=dt, cifar_stem=cs),
        lambda cs: port_segmentation.ResNetEncoder(
            [1, 1, 1, 1], port_encoders.SEBottleneck, num_filters=8,
            dtype=torch.float32, cifar_stem=cs)),
    'drn': (
        lambda cs, dt: jax_segmentation.ResNetEncoder(
            stage_sizes=[1, 1, 2, 1], block=JaxBasicBlock, num_filters=8,
            stage_dilations=(1, 1, 2, 4), dtype=dt, cifar_stem=cs),
        lambda cs: port_segmentation.ResNetEncoder(
            [1, 1, 2, 1], BasicBlock, num_filters=8,
            stage_dilations=(1, 1, 2, 4), dtype=torch.float32,
            cifar_stem=cs)),
}

#: (image size, cifar_stem): 30 halves to 15, an odd dim for the
#: stride-2 'SAME' pads and VALID pools after it
INPUTS = [(16, True), (30, False)]

#: the whole encoders, held in f32 eval mode at both inputs
ENCODERS = {
    **{k: v for k, v in FAMILIES.items() if k != 'xception_blocks'},
    'xception': (
        lambda cs, dt: jax_encoders.XceptionEncoder(
            middle_reps=1, dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.XceptionEncoder(
            middle_reps=1, dtype=torch.float32, cifar_stem=cs)),
    'dpn': (
        lambda cs, dt: jax_encoders.DPNEncoder(
            stage_blocks=(1, 2, 1, 1), dtype=dt, cifar_stem=cs),
        lambda cs: port_encoders.DPNEncoder(
            stage_blocks=(1, 2, 1, 1), dtype=torch.float32, cifar_stem=cs)),
}


def random_variables(module, x, seed=0):
    """Variables of ``module``'s tree (``jax.eval_shape`` of its init:
    nothing computed) drawn from a numpy seed, f32 values held in f64:
    kernels at unit fan-in scale, every norm's scale, bias and
    statistics at random (so no zero-init branch starts at zero)."""
    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), x, train=False)))
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == 'kernel':
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name in ('scale', 'var'):
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = 0.1 * rng.randn(*a.shape)
        return v.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_numbers(module, variables, x, probes) -> dict:
    """The eval pyramid, the train pyramid, the new running statistics and
    the gradients of sum(train pyramid * probes) over the params, of a
    JAX module (x64 enabled by the caller), as numpy."""
    def loss(params):
        feats, upd = module.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            x, train=True, mutable=['batch_stats'])
        return sum(jnp.sum(f * r) for f, r in zip(feats, probes)), \
            (feats, upd['batch_stats'])

    (_, (train, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    evals = jax.jit(partial(module.apply, train=False))(variables, x)
    return {'eval': [np.asarray(f) for f in evals],
            'train': [np.asarray(f) for f in train],
            'stats': image_state_dict_from_jax(
                {'params': {}, 'batch_stats': jax.tree.map(np.asarray,
                                                           stats)}),
            'grads': image_state_dict_from_jax(
                {'params': jax.tree.map(np.asarray, grads)})}


def port_numbers(model, x, probes) -> dict:
    """``jax_numbers`` of a port module (NHWC pyramids)."""
    dtype = next(model.parameters()).dtype
    x = to_nchw(torch.from_numpy(np.array(x)), dtype)
    with torch.no_grad():
        evals = [f.permute(0, 2, 3, 1).numpy() for f in model(x, train=False)]
    train = [f.permute(0, 2, 3, 1) for f in model(x, train=True)]
    loss = sum((f * torch.from_numpy(r).to(dtype)).sum()
               for f, r in zip(train, probes))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(('.mean', '.var'))}
    return {'eval': evals, 'train': [f.detach().numpy() for f in train],
            'stats': stats, 'grads': dict(zip(params, grads))}


def as_f64(model):
    """``model`` computing in f64: parameters, statistics and every
    module's compute dtype."""
    model.double()
    for module in model.modules():
        if hasattr(module, 'dtype'):
            module.dtype = torch.float64
    return model


def jax_reference(make_jax, x):
    """(variables, probes, numbers) of the JAX module in f64 from random
    weights. f64, because f32 gradients of deep train-mode batch norms
    are ill-conditioned: the backward subtracts the batch means of large
    terms, and flax's BatchNorm takes the one-pass variance E[x^2] -
    E[x]^2. Against an f64 run, JAX's f32 gradients were off by a third
    of a row at DPN's second stage (the port's f32 by 5e-3), so in f32
    the two packages can only be held to each other in eval mode."""
    with jax.enable_x64(True):
        module = make_jax(jnp.float64)
        x = jnp.asarray(x, jnp.float64)
        variables = random_variables(module, x)
        shapes = [f.shape for f in jax.eval_shape(
            partial(module.apply, train=False), variables, x)]
        rng = np.random.RandomState(1)
        probes = [rng.randn(*s) for s in shapes]
        return variables, probes, jax_numbers(module, variables, x, probes)


#: a row whose largest magnitude is below this share of the largest in
#: its part (all statistics, all gradients) is zero in exact arithmetic
#: (a bias before a train-mode norm that removes it) and holds rounding
#: noise on both sides
ZERO_ROW = 1e-9


def compare(got: dict, want: dict, parts=('eval', 'train', 'stats',
                                          'grads'), tol=ROW_TOL):
    for part in ('eval', 'train'):
        if part in parts:
            for i, (g, w) in enumerate(zip(got[part], want[part])):
                assert_rows_close(g, w, tol, what=f'{part} c{i + 1}')
    for part in ('stats', 'grads'):
        if part in parts:
            assert sorted(got[part]) == sorted(want[part])
            floor = ZERO_ROW * max(float(v.abs().max())
                                   for v in want[part].values())
            for key, value in want[part].items():
                assert_rows_close(got[part][key].detach().numpy(),
                                  value.numpy(), tol, what=f'{part} {key}',
                                  floor=floor)


#: families with squeeze-excite: its gate runs in f32 in both packages
#: (JAX's ``SqueezeExcite`` casts to f32), an f32 island in the f64
#: comparison whose rounding reaches the gradients upstream of it
#: (measured 2.7e-5 of a row)
SE_GRAD_TOL = 1e-4


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_family_matches_jax(family):
    """16x16 images through the ``cifar_stem`` variant: the port in f64
    against JAX in f64 (the same math), the pyramids, statistics and
    gradients within ROW_TOL; the port in f32, its eval pyramid within
    ROW_TOL of the same oracle."""
    make_jax, make_port = FAMILIES[family]
    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    variables, probes, want = jax_reference(partial(make_jax, True), x)
    sd = image_state_dict_from_jax(variables)
    port = make_port(True)
    assert [f.shape[-1] for f in want['eval']] == list(port.channels)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(to_nchw(torch.from_numpy(x), torch.float32))
    compare({'eval': [f.permute(0, 2, 3, 1).numpy() for f in got]}, want,
            parts=('eval',))
    port = as_f64(make_port(True))
    port.load_state_dict(sd)
    got = port_numbers(port, x, probes)
    if family.startswith('seresnet'):
        compare(got, want, parts=('eval', 'train', 'stats'))
        compare(got, want, parts=('grads',), tol=SE_GRAD_TOL)
    else:
        compare(got, want)


@pytest.mark.parametrize('size,cifar_stem', INPUTS,
                         ids=[f'{s}{"-cifar" if c else ""}'
                              for s, c in INPUTS])
@pytest.mark.parametrize('family', sorted(ENCODERS))
def test_encoder_eval_matches_jax_in_f32(family, size, cifar_stem):
    """Each whole encoder (Xception and DPN at full width) in f32 eval
    mode, where the running statistics normalise: the pyramid within
    ROW_TOL of JAX's in f32."""
    make_jax, make_port = ENCODERS[family]
    x = jnp.asarray(np.random.RandomState(5).randn(2, size, size, 3),
                    jnp.float32)
    module = make_jax(cifar_stem, jnp.float32)
    variables = jax.tree.map(lambda a: a.astype(np.float32),
                             random_variables(module, x))
    want = jax.jit(partial(module.apply, train=False))(variables, x)
    port = make_port(cifar_stem)
    port.load_state_dict(image_state_dict_from_jax(variables))
    with torch.no_grad():
        got = port(to_nchw(torch.from_numpy(np.array(x)), torch.float32))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rows_close(g.permute(0, 2, 3, 1).numpy(), w,
                          what=f'c{i + 1}')


def test_efficientnet_pads_the_pyramid_with_its_first_level():
    port = port_encoders.EfficientNetEncoder(
        _EFF_TWO, stem_features=8, dtype=torch.float32)
    x = to_nchw(torch.randn(1, 16, 16, 3), torch.float32)
    feats = port(x)
    assert all(f is feats[0] for f in feats[:4])
    assert port.channels == [8, 8, 8, 8, 16]


@pytest.mark.parametrize('name', ['vgg13'])
def test_classifier_logits_match_jax(name):
    """``EncoderClassifier`` end to end at full width (GAP, f32 head), the
    port in f32 against JAX's f64 logits, eval then train mode."""
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    spec = {'name': name, 'num_classes': 10, 'cifar_stem': True}
    with jax.enable_x64(True):
        jmodel = jax_create_model(**spec, dtype='float64')
        x64 = jnp.asarray(x, jnp.float64)
        variables = random_variables(jmodel, x64)
        want = [np.asarray(jmodel.apply(variables, x64, train=False)),
                np.asarray(jmodel.apply(variables, x64, train=True,
                                        mutable=['batch_stats'])[0])]
    port = create_model(**spec, dtype='float32', device='cpu')
    port.load_state_dict(image_state_dict_from_jax(variables))
    for train, w in zip((False, True), want):
        with torch.no_grad():
            got = port(torch.from_numpy(x), train=train)
        assert_rows_close(got.numpy(), w, what=f'{name} train={train}')

"""The port's segmentation slice against the JAX package's, on the CPU:
the decoders and U-Nets, ``resize_to``, the segmentation losses,
``synthetic_segmentation``, the host augment pipeline and RLE codec,
``iterate_batches`` with a transform, and ``examples/segmentation`` run
through the port's executors.

Models are held as in ``test_torch_port_encoders.py``: JAX in f64 is the
oracle (the reason is in its ``jax_reference``), the port runs in f64
(outputs and running statistics within ROW_TOL of each row's largest
magnitude, gradients within SEG_GRAD_TOL) and in f32 (eval output within
ROW_TOL). The decoders
sit over narrow encoders registered for the test in both packages'
``ENCODER_FACTORIES``: a ResNet of one block a stage at 8 filters, and
a two-stage EfficientNet table (one stride-2 stage, so its pyramid
repeats c1). Everything numpy-only (data, augmentations, RLE) is
compared bit for bit.
"""

import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu.contrib import criterion as jax_criterion
from mlcomp_tpu.contrib.transform import numpy_aug as jax_aug
from mlcomp_tpu.contrib.transform import rle as jax_rle
from mlcomp_tpu.models import base as jax_base
from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.models import encoders as jax_encoders
from mlcomp_tpu.models import segmentation as jax_segmentation
from mlcomp_tpu.models.resnet import BasicBlock as JaxBasicBlock
from mlcomp_tpu.train import data as jax_data
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.worker.executors import Executor as JaxExecutor
from mlcomp_tpu_torch.contrib import criterion as port_criterion
from mlcomp_tpu_torch.contrib.metrics import dice_numpy, iou_numpy
from mlcomp_tpu_torch.contrib.transform import numpy_aug as port_aug
from mlcomp_tpu_torch.contrib.transform import rle as port_rle
from mlcomp_tpu_torch.convert import (
    image_state_dict_from_jax, input_shape_from_params,
)
from mlcomp_tpu_torch.models import base as port_base
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models import encoders as port_encoders
from mlcomp_tpu_torch.models import segmentation as port_segmentation
from mlcomp_tpu_torch.models.resnet import BasicBlock
from mlcomp_tpu_torch.train import data as port_data
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train.export import load_export
from mlcomp_tpu_torch.worker.executors import Executor

from test_torch_port_encoders import (
    as_f64, assert_rows_close, random_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a segmentation model's gradients: JAX's head (``classifier``, the
#: final resize; the standalone U-Net's ``head``) runs in f32 even in an
#: f64 model, so every gradient upstream carries f32 rounding (measured
#: 1.1e-5 of a row at LinkNet's first up-block)
SEG_GRAD_TOL = 1e-4
#: the losses in f32 on both sides: values and gradients with respect to
#: the logits (a softmax and sums over 64 pixels) agree to rounding
LOSS_TOL = 1e-5

_EFF_TWO = ((1, 8, 1, 1, 3), (6, 16, 2, 2, 5))


@pytest.fixture(autouse=True)
def narrow_encoders(monkeypatch):
    """``resnet_narrow`` and ``effnet_narrow`` in both packages' encoder
    registries, and the U-Net decoder over the first as
    ``unet_resnet_narrow``."""
    monkeypatch.setitem(
        jax_encoders.ENCODER_FACTORIES, 'resnet_narrow',
        lambda dtype, cifar_stem: jax_segmentation.ResNetEncoder(
            stage_sizes=[1, 1, 1, 1], block=JaxBasicBlock, num_filters=8,
            cifar_stem=cifar_stem, dtype=dtype))
    monkeypatch.setitem(
        port_encoders.ENCODER_FACTORIES, 'resnet_narrow',
        lambda dtype, cifar_stem, in_channels, device:
        port_segmentation.ResNetEncoder(
            [1, 1, 1, 1], BasicBlock, num_filters=8, cifar_stem=cifar_stem,
            dtype=dtype, in_channels=in_channels, device=device))
    monkeypatch.setitem(
        jax_base._REGISTRY, 'unet_resnet_narrow',
        lambda **kw: jax_segmentation._seg_factory(
            jax_segmentation.UNetDecoder)(encoder='resnet_narrow', **kw))
    monkeypatch.setitem(
        port_base._REGISTRY, 'unet_resnet_narrow',
        lambda **kw: port_segmentation._seg_factory(
            port_segmentation.UNetDecoder)(encoder='resnet_narrow', **kw))
    monkeypatch.setitem(
        jax_encoders.ENCODER_FACTORIES, 'effnet_narrow',
        lambda dtype, cifar_stem: jax_encoders.EfficientNetEncoder(
            stages=_EFF_TWO, stem_features=8, dtype=dtype,
            cifar_stem=cifar_stem))
    monkeypatch.setitem(
        port_encoders.ENCODER_FACTORIES, 'effnet_narrow',
        lambda dtype, cifar_stem, in_channels, device:
        port_encoders.EfficientNetEncoder(
            _EFF_TWO, stem_features=8, dtype=dtype, cifar_stem=cifar_stem,
            in_channels=in_channels, device=device))


# ------------------------------------------------------------- models
def model_numbers_jax(spec, x, seed=0):
    """JAX's (variables, probe, numbers) of a segmentation model in f64:
    the eval and train logits, the new statistics and the gradients of
    sum(train logits * probe)."""
    with jax.enable_x64(True):
        model = jax_create_model(**spec, dtype='float64')
        x = jnp.asarray(x, jnp.float64)
        variables = random_variables(model, x, seed)
        shape = jax.eval_shape(partial(model.apply, train=False),
                               variables, x).shape
        probe = np.random.RandomState(1).randn(*shape)

        def loss(params):
            out, upd = model.apply(
                {'params': params,
                 'batch_stats': variables.get('batch_stats', {})},
                x, train=True, mutable=['batch_stats'])
            return jnp.sum(out * probe), (out, upd['batch_stats'])

        (_, (train, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables['params'])
        evals = jax.jit(partial(model.apply, train=False))(variables, x)
        return variables, probe, {
            'eval': np.asarray(evals), 'train': np.asarray(train),
            'stats': image_state_dict_from_jax(
                {'params': {},
                 'batch_stats': jax.tree.map(np.asarray, stats)}),
            'grads': image_state_dict_from_jax(
                {'params': jax.tree.map(np.asarray, grads)})}


def check_model(spec, x):
    variables, probe, want = model_numbers_jax(spec, x)
    sd = image_state_dict_from_jax(variables)
    port = create_model(**spec, dtype='float32', device='cpu', input_shape=(
        input_shape_from_params(spec['name'], variables['params'])))
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want['eval'].shape
    assert_rows_close(got.numpy(), want['eval'], what='f32 eval')
    port = as_f64(port)
    port.load_state_dict(sd)
    with torch.no_grad():
        assert_rows_close(port(torch.from_numpy(x)).numpy(), want['eval'],
                          what='eval')
    out = port(torch.from_numpy(x), train=True)
    assert_rows_close(out.detach().numpy(), want['train'], what='train')
    sd_now = port.state_dict()
    for key, value in want['stats'].items():
        assert_rows_close(sd_now[key].numpy(), value.numpy(), what=key)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                list(params.values()))
    assert sorted(params) == sorted(want['grads'])
    floor = 1e-9 * max(float(v.abs().max()) for v in want['grads'].values())
    for key, g in zip(params, grads):
        assert_rows_close(g.numpy(), want['grads'][key].numpy(),
                          SEG_GRAD_TOL, what=f'grad {key}', floor=floor)
    return want


_NARROW = {'pyramid_channels': 16, 'segmentation_channels': 8,
           'psp_channels': 8, 'aspp_channels': 8,
           'decoder_channels': (16, 8, 8, 8)}


@pytest.mark.parametrize('name,encoder,size,cifar_stem', [
    ('fpn', 'resnet_narrow', 30, False),
    ('linknet', 'resnet_narrow', 30, False),
    ('pspnet', 'resnet_narrow', 30, False),
    ('deeplabv3', 'resnet_narrow', 30, False),
    ('unet_resnet_narrow', None, 30, False),
    ('fpn', 'effnet_narrow', 16, False),
    ('deeplabv3_drn26', None, 24, False),
])
def test_decoder_matches_jax(name, encoder, size, cifar_stem):
    """Each decoder over a narrow ResNet on 30x30 images (the pyramid at
    15, 8, 8, 4, 2, 1: odd dims, and the head's resize from 8 to 30);
    FPN over the two-stage EfficientNet (its repeated c1); DeepLabV3
    over the full-width DRN-26 (c3..c5 at one resolution, rates 6/12/18
    wider than the map)."""
    spec = {'name': name, 'num_classes': 3, 'cifar_stem': cifar_stem,
            **_NARROW}
    if encoder:
        spec['encoder'] = encoder
    if name == 'deeplabv3_drn26':
        spec = {'name': name, 'num_classes': 2, 'aspp_channels': 8}
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    want = check_model(spec, x)
    assert want['eval'].shape == (2, size, size, spec['num_classes'])


def test_registered_unet_encoder_alias_is_the_decoder():
    model = create_model('unet_resnet18', num_classes=2, device='cpu')
    assert isinstance(model, port_segmentation.UNetDecoder)
    assert model.encoder_key == 'ResNetEncoder_0'


def test_standalone_unet_matches_jax():
    spec = {'name': 'unet', 'num_classes': 2, 'filters': (8, 16, 32)}
    x = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
    check_model(spec, x)


def test_fpn_efficientnet_lite0_eval_matches_jax():
    """``fpn_efficientnet_lite0`` at full width, f32 eval."""
    spec = {'name': 'fpn_efficientnet_lite0', 'num_classes': 2}
    x = jnp.asarray(np.random.RandomState(2).randn(2, 32, 32, 3),
                    jnp.float32)
    model = jax_create_model(**spec, dtype='float32')
    variables = jax.tree.map(lambda a: a.astype(np.float32),
                             random_variables(model, x))
    want = jax.jit(partial(model.apply, train=False))(variables, x)
    port = create_model(**spec, dtype='float32', device='cpu')
    port.load_state_dict(image_state_dict_from_jax(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x)))
    assert_rows_close(got.numpy(), want, what='logits')


@pytest.mark.parametrize('size,c5', [(32, 4), (40, 5)])
def test_pspnet_pools_with_jax_s_windows(size, c5):
    """PSPNet's pools are windows of (h // bins) with that stride, VALID
    (not adaptive): on a 4x4 c5 bins 3 pools 1x1 windows into 4x4, on a
    5x5 one 1x1 into 5x5 and bins 2 2x2 windows into 2x2."""
    spec = {'name': 'pspnet', 'encoder': 'resnet_narrow', 'num_classes': 2,
            'cifar_stem': True, 'psp_channels': 8}
    x = np.random.RandomState(6).randn(2, size, size, 3).astype(np.float32)
    port = create_model(**spec, device='cpu', dtype='float32')
    enc = getattr(port, port.encoder_key)
    feats = enc(port_segmentation.to_nchw(torch.from_numpy(x), torch.float32))
    assert tuple(feats[4].shape[2:]) == (c5, c5)
    check_model(spec, x)


# ------------------------------------------------------------- resize
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
@pytest.mark.parametrize('src,dst', [
    ((4, 4), (8, 8)), ((7, 7), (13, 13)), ((13, 13), (25, 25)),
    ((25, 25), (100, 100)), ((8, 8), (4, 4)), ((13, 13), (7, 7)),
    ((100, 100), (25, 25)), ((7, 12), (13, 5)), ((1, 1), (3, 3)),
    ((6, 6), (6, 6))])
def test_resize_to_is_jax_image_resize(method, src, dst):
    """``jax.image.resize``: bilinear is antialiased where a dim shrinks;
    nearest is 'nearest-exact' (f32, within 2e-6 of the values' range:
    the interpolation weights are computed in another order)."""
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 3), method=method)
    got = port_segmentation.resize_to(
        torch.from_numpy(x).permute(0, 3, 1, 2), dst, method)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=2e-6)


def test_resize_to_refuses_other_methods():
    with pytest.raises(ValueError, match='resize method'):
        port_segmentation.resize_to(torch.zeros(1, 1, 2, 2), (3, 3), 'cubic')


# ------------------------------------------------------------- data
def test_synthetic_segmentation_is_jax_s_bit_for_bit():
    kw = {'n_train': 24, 'n_valid': 8, 'image_size': 32, 'num_classes': 3,
          'seed': 5}
    got = port_data.create_dataset('synthetic_segmentation', **kw)
    want = jax_data.create_dataset('synthetic_segmentation', **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_digits_segmentation_names_scikit_learn():
    with pytest.raises(NotImplementedError, match='scikit-learn'):
        port_data.create_dataset('digits_segmentation')


# ------------------------------------------------------------- losses
C = 3


def _logits_labels(seed=0, special=()):
    rng = np.random.RandomState(seed)
    logits = rng.randn(4, 4, 4, C).astype(np.float32)
    labels = rng.randint(0, C, (4, 4, 4)).astype(np.int32)
    for i, value in enumerate(special):
        labels[i, 0, i] = value
    return logits, labels


def _jax_loss(name, logits, labels, weights):
    fn = jax_loop.loss_for_task(name)
    w = None if weights is None else jnp.asarray(weights)

    def scalar(lg):
        return fn(lg, jnp.asarray(labels), w)[0]

    loss, metrics = fn(jnp.asarray(logits), jnp.asarray(labels), w)
    grad = jax.grad(scalar)(jnp.asarray(logits))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        np.asarray(grad)


def _port_loss(name, logits, labels, weights):
    fn = port_loop.loss_for_task(name)
    lg = torch.from_numpy(logits).requires_grad_()
    w = None if weights is None else torch.from_numpy(weights)
    loss, metrics = fn(lg, torch.from_numpy(labels), w)
    (grad,) = torch.autograd.grad(loss, lg)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        grad.numpy()


@pytest.mark.parametrize('weights', [None, np.array([1, 0, 1, 1], np.float32),
                                     np.array([0.5, 2, 1, 0], np.float32)],
                         ids=['unweighted', 'mask', 'weights'])
@pytest.mark.parametrize('name', ['dice', 'bce_dice', 'focal'])
def test_loss_values_and_gradients_are_jax_s(name, weights):
    logits, labels = _logits_labels(special=(-C, -1, C - 1))
    want = _jax_loss(name, logits, labels, weights)
    got = _port_loss(name, logits, labels, weights)
    assert got[1].keys() == want[1].keys()
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_TOL, atol=1e-7)
    for key in want[1]:
        np.testing.assert_allclose(got[1][key], want[1][key],
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got[2], want[2], rtol=LOSS_TOL, atol=1e-8)


@pytest.mark.parametrize('label', [C, -C - 1, 7])
@pytest.mark.parametrize('name', ['dice', 'bce_dice', 'focal'])
def test_out_of_range_labels_follow_jax(name, label):
    """A label outside [-C, C): NaN where JAX's cross-entropy or
    ``take_along_axis`` reads it (``bce_dice``, ``focal``), the one-hot
    clamped where ``jnp.eye(C)[labels]`` does (``dice``); nothing
    raises."""
    logits, labels = _logits_labels(seed=1, special=(label,))
    want = jax_loop.loss_for_task(name)(jnp.asarray(logits),
                                        jnp.asarray(labels))[0]
    got = port_loop.loss_for_task(name)(torch.from_numpy(logits),
                                        torch.from_numpy(labels))[0]
    assert np.isnan(float(got)) == np.isnan(float(want)) == (name != 'dice')
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


def test_contrib_losses_register_on_demand():
    for name in ('dice', 'bce_dice', 'focal'):
        assert port_loop.loss_for_task(name) is port_loop.LOSSES[name]
    assert port_loop.LOSSES['bce_dice'] is port_criterion.bce_dice


def test_ring_penalty_is_jax_s():
    feats = np.random.RandomState(3).randn(5, 4, 3).astype(np.float32)
    want = jax_criterion.ring_penalty(jnp.asarray(feats), 2.5)
    got = port_criterion.ring_penalty(torch.from_numpy(feats), 2.5)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


# ------------------------------------------------------------- augment
def _batch(seed=0, n=6, hw=(8, 8)):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *hw, 3).astype(np.float32)
    masks = rng.randint(0, 3, (n, *hw)).astype(np.int32)
    return x, masks


TRANSFORMS = [('HorizontalFlip', {'p': 0.5}), ('VerticalFlip', {'p': 0.5}),
              ('Transpose', {'p': 1.0}), ('PadCrop', {'pad': 2, 'p': 0.7}),
              ('Cutout', {'size': 4, 'p': 0.6})]


@pytest.mark.parametrize('masks', [False, True], ids=['images', 'masks'])
@pytest.mark.parametrize('name,kw', TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_each_transform_is_jax_s(name, kw, masks):
    """Per sample (``transform(img, mask, rng)``) and batched
    (``augment_batch``: the vectorised path where the transform has one,
    the per-sample loop where not), from the same ``RandomState``."""
    x, m = _batch()
    m = m if masks else None
    jt, pt = getattr(jax_aug, name)(**kw), getattr(port_aug, name)(**kw)
    for i in range(len(x)):
        want = jt(x[i], None if m is None else m[i],
                  np.random.RandomState(i))
        got = pt(x[i], None if m is None else m[i],
                 np.random.RandomState(i))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    want = jax_aug.augment_batch(x, jax_aug.Compose([jt]),
                                 np.random.RandomState(9), masks=m)
    got = port_aug.augment_batch(x, port_aug.Compose([pt]),
                                 np.random.RandomState(9), masks=m)
    for g, w in zip(got if m is not None else [got],
                    want if m is not None else [want]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('specs', [
    ['hflip', 'vflip', {'name': 'pad_crop', 'pad': 2}, 'cutout'],
    ['transpose', 'hflip'],
    [{'name': 'cutout', 'size': 2, 'p': 1.0}]])
def test_parse_transforms_and_augment_batch_are_jax_s(specs):
    x, m = _batch(seed=1)
    jt, pt = jax_aug.parse_transforms(specs), port_aug.parse_transforms(specs)
    assert [type(t).__name__ for t in pt.transforms] == \
        [type(t).__name__ for t in jt.transforms]
    for masks in (None, m):
        want = jax_aug.augment_batch(x, jt, np.random.RandomState(4),
                                     masks=masks)
        got = port_aug.augment_batch(x, pt, np.random.RandomState(4),
                                     masks=masks)
        for g, w in zip(got if masks is not None else [got],
                        want if masks is not None else [want]):
            np.testing.assert_array_equal(g, w)


def test_mixed_shapes_raise_as_in_jax():
    x = np.zeros((16, 6, 8, 3), np.float32)
    with pytest.raises(ValueError, match='mixed sample shapes'):
        port_aug.augment_batch(x, port_aug.Transpose(p=0.5),
                               np.random.RandomState(0))


@pytest.mark.parametrize('shape', [(8, 8), (5, 7), (1, 9)])
def test_rle_round_trips_and_is_jax_s(shape):
    mask = (np.random.RandomState(2).rand(*shape) > 0.5).astype(np.uint8)
    rle = port_rle.mask2rle(mask)
    assert rle == jax_rle.mask2rle(mask)
    back = port_rle.rle2mask(rle, shape[::-1])
    np.testing.assert_array_equal(back, mask)
    np.testing.assert_array_equal(back, jax_rle.rle2mask(rle, shape[::-1]))
    assert port_rle.mask2rle(np.zeros(shape)) == ''


@pytest.mark.parametrize('with_rng', [True, False])
@pytest.mark.parametrize('labels', ['masks', 'classes'])
def test_iterate_batches_with_transform_is_jax_s(labels, with_rng):
    """Shuffle, then augment each batch from the same ``rng`` (or a
    ``RandomState(0)`` per batch without one); masks go along."""
    x, m = _batch(seed=2, n=10)
    y = m if labels == 'masks' else np.arange(10, dtype=np.int32)
    specs = ['hflip', 'transpose', {'name': 'pad_crop', 'pad': 1}]
    got = list(port_data.iterate_batches(
        x, y, 4, np.random.RandomState(3) if with_rng else None,
        drop_last=False, transform=port_aug.parse_transforms(specs)))
    want = list(jax_data.iterate_batches(
        x, y, 4, np.random.RandomState(3) if with_rng else None,
        drop_last=False, transform=jax_aug.parse_transforms(specs)))
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# ------------------------------------------------------------- the DAG
def _segmentation_dag(tmp_path):
    """``examples/segmentation/config.yml`` for the port on the CPU. Cuts:
    4 epochs -> 1, 512/64 images -> 64/16, the model in f32 (bf16
    convolutions are slow on the CPU); ``report_imgs`` dropped (report
    images need the DB, ROADMAP.md A0); ``type: jax_train`` read as the
    port's ``train``."""
    with open(os.path.join(REPO, 'examples', 'segmentation',
                           'config.yml')) as fh:
        executors = yaml.safe_load(fh)['executors']
    for spec in executors.values():
        spec['dataset'].update(n_train=64, n_valid=16)
        spec['device'] = 'cpu'
    train = executors['train']
    train.pop('report_imgs')
    train.update(type='train', checkpoint_dir=str(tmp_path / 'ck'))
    train['model']['dtype'] = 'float32'
    train['stages'][0]['epochs'] = 1
    executors['valid'] = {'type': 'valid_segment', 'metric': 'dice',
                          'dataset': executors['infer']['dataset'],
                          'y': "load('seg_fpn')", 'depends': 'infer',
                          'device': 'cpu'}
    return executors


def test_segmentation_example_runs_on_the_port(tmp_path, monkeypatch):
    """train -> infer (argmax) -> valid_segment through the port's
    executors; the scores are ``dice_numpy`` of the saved predictions,
    and JAX's ``InferClassify`` over the port's export gives the same
    argmax."""
    executors = _segmentation_dag(tmp_path)
    config = {'executors': executors}
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    results = {name: Executor.from_config(name, config)()
               for name in ('train', 'infer', 'valid')}
    assert np.isfinite(results['train']['best_score'])
    preds = np.load(port_dir / 'data' / 'pred' / 'seg_fpn.npy')
    data = port_data.create_dataset(**executors['infer']['dataset'])
    assert preds.shape == (16, 64, 64) and preds.dtype == np.int32
    assert results['valid']['score'] == dice_numpy(data['y_valid'] > 0,
                                                   preds > 0)
    assert iou_numpy(data['y_valid'] > 0, preds > 0) <= 1.0
    _, spec = load_export(port_dir / 'models' / 'seg_fpn')
    assert spec == executors['train']['model']
    shutil.copytree(port_dir / 'models', jax_dir / 'models')
    monkeypatch.chdir(jax_dir)
    infer = {k: v for k, v in executors['infer'].items()
             if k not in ('type', 'depends', 'device')}
    JaxExecutor.get('infer_classify')(**infer).work()
    np.testing.assert_array_equal(
        np.load(jax_dir / 'data' / 'pred' / 'seg_fpn.npy'), preds)


def test_host_augment_trains(tmp_path, monkeypatch):
    """A transform the device cannot run (``transpose``) takes the host
    pipeline, masks along, and trains."""
    executors = _segmentation_dag(tmp_path)
    train = dict(executors['train'], augment=['transpose', 'hflip'],
                 device_data=False, model_name=None)
    train['model'] = dict(train['model'], encoder='resnet_narrow')
    train['dataset'] = dict(train['dataset'], n_train=32, image_size=16)
    monkeypatch.chdir(tmp_path)
    result = Executor.from_config('train', {'executors': {
        'train': train}})()
    assert np.isfinite(result['best_score'])

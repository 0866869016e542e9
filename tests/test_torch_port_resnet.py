"""The port's CIFAR/digits training path against the JAX package's, on
the CPU: the ResNets (``batch``, ``fused`` and ``none`` norms) and the
MLP, the converter with ``batch_stats``, two SGD steps, the image
datasets, the device-resident data path and its augmentations, and the
``train`` executor end to end.

Inputs come from numpy seeds; weights cross from JAX to the port with
``convert.image_state_dict_from_jax``. The models are cut to
``num_filters=8`` on 8x8 images so every test stays cheap; their stride-2
convs still pad asymmetrically (flax 'SAME' on even inputs). JAX's fused
norm runs as ``norm_impl='dense'`` or, in one case, under the Pallas
interpreter (``'interpret'``). Tolerances are stated where they are
used.
"""

import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import data as jax_data
from mlcomp_tpu.train import device_data as jax_device_data
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.train import optim as jax_optim
from mlcomp_tpu_torch.convert import (
    image_state_dict_from_jax, image_variables_to_jax,
    input_shape_from_params, state_dict_from_jax,
)
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.resnet import same_pads
from mlcomp_tpu_torch.train import data as port_data
from mlcomp_tpu_torch.train import device_data as port_device_data
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train import optim as port_optim
from mlcomp_tpu_torch.worker.executors import Executor

#: f32 on both sides, through up to 20 norm sites: the statistics sum in
#: another order (measured worst logit error ~3e-6)
F32_TOL = 1e-4


def _spec(norm, impl='dense', **over):
    return {'name': 'resnet18', 'num_classes': 10, 'dtype': 'float32',
            'norm': norm, 'norm_impl': impl, 'num_filters': 8, **over}


def _images(n, hw=8, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, hw, hw, c) + 0.5).astype(np.float32)


def _jax_variables(spec, x, seed=1):
    variables = jax_create_model(**spec).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))


def _port_model(spec, variables):
    model = create_model(**spec, device='cpu', input_shape=(
        input_shape_from_params(spec['name'], variables['params'])))
    model.load_state_dict(image_state_dict_from_jax(variables))
    return model


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(('.mean', '.var'))}


# ------------------------------------------------------------------ models
class TestResNet:
    @pytest.mark.parametrize('norm,impl,n,hw,cifar_stem', [
        ('batch', 'dense', 4, 8, True),
        ('fused', 'dense', 4, 8, True),
        ('none', 'dense', 4, 8, True),
        # the Pallas kernel under the interpreter needs R % 8 == 0 at
        # every site: 8 images leave 8 rows at stage 4
        ('fused', 'interpret', 8, 8, True),
        # the ImageNet stem: a 7x7 stride-2 conv padded (2, 3) and a 3x3
        # stride-2 max-pool padded (0, 1)
        ('batch', 'dense', 2, 16, False),
    ])
    def test_train_and_eval_logits_and_stats(self, norm, impl, n, hw,
                                             cifar_stem):
        spec = _spec(norm, impl, cifar_stem=cifar_stem)
        x = _images(n, hw)
        variables = _jax_variables(spec, x)
        model = _port_model(spec, variables)
        jmodel = jax_create_model(**spec)
        want, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=['batch_stats'])
        with torch.no_grad():
            got = model(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
        if norm == 'none':
            assert 'batch_stats' not in variables and not _stats(
                model.state_dict())
        else:
            new = image_state_dict_from_jax(
                {'params': variables['params'],
                 'batch_stats': jax.tree.map(np.asarray,
                                             updates['batch_stats'])})
            for key, value in _stats(model.state_dict()).items():
                np.testing.assert_allclose(value.numpy(), new[key].numpy(),
                                           rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=key)
            variables = dict(variables, batch_stats=updates['batch_stats'])
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize('size,kernel,stride,want', [
        (32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
        (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (32, 1, 2, (0, 0)),
        (1, 3, 2, (1, 1)), (2, 3, 2, (0, 1))])
    def test_same_pads_are_xla_s(self, size, kernel, stride, want):
        from jax import lax
        assert same_pads(size, kernel, stride) == want
        assert tuple(lax.padtype_to_pads((size,), (kernel,), (stride,),
                                         'SAME')[0]) == want

    def test_fused_and_batch_checkpoints_interchange(self):
        """The ``fused`` variant's parameters and statistics are the
        ``batch`` variant's, so a BN checkpoint drives the fused model
        (eval: running statistics through the plain version)."""
        x = _images(4)
        variables = _jax_variables(_spec('batch'), x)
        batch = _port_model(_spec('batch'), variables)
        fused = create_model(**_spec('fused'), device='cpu')
        assert batch.state_dict().keys() == fused.state_dict().keys()
        fused.load_state_dict(batch.state_dict())
        with torch.no_grad():
            torch.testing.assert_close(fused(torch.from_numpy(x)),
                                       batch(torch.from_numpy(x)),
                                       rtol=1e-5, atol=1e-5)

    def test_param_count_is_jax_s(self):
        x = _images(2, 32)
        spec = _spec('fused', num_filters=64)
        variables = jax.eval_shape(
            lambda: jax_create_model(**spec).init(
                jax.random.PRNGKey(0), jnp.asarray(x), train=False))
        want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            nn.meta.unbox(variables['params'])))
        model = create_model(**spec, device='cpu')
        assert sum(p.numel() for p in model.parameters()) == want \
            == 11_173_962

    def test_bf16_model_runs_channels_last(self):
        model = create_model(**_spec('fused', dtype='bfloat16'), device='cpu')
        with torch.no_grad():
            out = model(torch.from_numpy(_images(2)), train=True)
        assert out.dtype == torch.float32 and out.shape == (2, 10)
        assert torch.isfinite(out).all()

    def test_unknown_norm_raises(self):
        with pytest.raises(ValueError, match='unknown norm'):
            create_model(**_spec('group'), device='cpu')


class TestMlp:
    def test_logits_are_jax_s(self):
        spec = {'name': 'mlp', 'num_classes': 10, 'hidden': [32, 16],
                'dtype': 'float32'}
        x = _images(5, 8, 1)
        variables = jax.tree.map(np.asarray, nn.meta.unbox(
            jax_create_model(**spec).init(jax.random.PRNGKey(0),
                                          jnp.asarray(x))))
        model = create_model(**spec, device='cpu', input_shape=(8, 8, 1))
        model.load_state_dict(state_dict_from_jax(variables, 'mlp'))
        want = jax_create_model(**spec).apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        assert input_shape_from_params('mlp', variables['params']) == (64,)


class TestConvert:
    @pytest.mark.parametrize('norm', ['batch', 'none'])
    def test_round_trip_with_batch_stats(self, norm):
        x = _images(2)
        variables = _jax_variables(_spec(norm), x)
        back = image_variables_to_jax(image_state_dict_from_jax(variables))
        assert jax.tree.structure(back) == jax.tree.structure(variables)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(np.asarray(a), b)

    def test_layouts(self):
        variables = _jax_variables(_spec('batch'), _images(2))
        sd = image_state_dict_from_jax(variables)
        kernel = variables['params']['BasicBlock_2']['Conv_0']['kernel']
        assert kernel.shape == (3, 3, 8, 16)
        np.testing.assert_array_equal(
            sd['BasicBlock_2.Conv_0.weight'].numpy(),
            kernel.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd['head.weight'].numpy(),
            variables['params']['head']['kernel'].T)
        np.testing.assert_array_equal(
            sd['norm_stem.var'].numpy(),
            variables['batch_stats']['norm_stem']['var'])


# ------------------------------------------------------------------- steps
class TestTrainSteps:
    def test_two_sgd_steps_are_jax_s(self):
        """Loss, parameters and running statistics after two SGD steps
        (lr 0.1, momentum 0.9, as bench.py's CIFAR leg) of the fused
        ResNet against the JAX package's jitted ``make_train_step``."""
        spec = _spec('fused')
        x = _images(8, seed=2)
        y = np.random.RandomState(3).randint(0, 10, 8).astype(np.int32)
        opt_spec = {'name': 'sgd', 'lr': 0.1, 'momentum': 0.9}
        jmodel = jax_create_model(**spec)
        jopt, _ = jax_optim.make_optimizer(opt_spec, 100)
        state = jax_loop.create_train_state(jmodel, jopt, jnp.asarray(x[:1]),
                                            jax.random.PRNGKey(4))
        variables = jax.tree.map(np.asarray, {
            'params': nn.meta.unbox(state.params),
            'batch_stats': state.batch_stats})
        model = _port_model(spec, variables)
        popt, _ = port_optim.make_optimizer(opt_spec, 100)
        pstate = port_loop.create_train_state(model, popt)
        jstep = jax_loop.make_train_step(jmodel, jopt, jax_loop.softmax_ce)
        pstep = port_loop.make_train_step(model, popt, port_loop.softmax_ce)
        for _ in range(2):
            state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y))
            pstate, pm = pstep(pstate, torch.from_numpy(x),
                               torch.from_numpy(y))
            np.testing.assert_allclose(float(pm['loss']), float(jm['loss']),
                                       rtol=F32_TOL)
        want = image_state_dict_from_jax(jax.tree.map(np.asarray, {
            'params': nn.meta.unbox(state.params),
            'batch_stats': state.batch_stats}))
        got = model.state_dict()
        assert got.keys() == want.keys() and pstate.step == 2
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=key)
        assert pstate.batch_stats.keys() == _stats(got).keys()


# -------------------------------------------------------------------- data
class TestData:
    @pytest.mark.parametrize('name,kw', [
        ('synthetic_images', dict(n_train=12, n_valid=4, image_size=8,
                                  channels=3, num_classes=5, seed=3)),
        ('cifar10', dict(n_train=6, n_valid=3, seed=1)),
        ('digits', dict(seed=2, valid_fraction=0.3)),
    ])
    def test_loaders_give_jax_s_arrays(self, name, kw, monkeypatch):
        monkeypatch.delenv('CIFAR10_NPZ', raising=False)
        want = jax_data.create_dataset(name, **kw)
        got = port_data.create_dataset(name, **kw)
        for key in ('x_train', 'y_train', 'x_valid', 'y_valid'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got.get('source') == want.get('source')

    def test_cifar10_reads_an_npz(self, tmp_path, monkeypatch):
        rng = np.random.RandomState(0)
        np.savez(tmp_path / 'c.npz',
                 x_train=rng.randint(0, 256, (5, 32, 32, 3)).astype(np.uint8),
                 y_train=np.arange(5), x_test=rng.randint(
                     0, 256, (2, 32, 32, 3)).astype(np.uint8),
                 y_test=np.arange(2))
        monkeypatch.setenv('CIFAR10_NPZ', str(tmp_path / 'c.npz'))
        want = jax_data.create_dataset('cifar10', n_train=4)
        got = port_data.create_dataset('cifar10', n_train=4)
        for key in ('x_train', 'y_train', 'x_valid', 'y_valid'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got['x_train'].max() <= 1.0 and len(got['x_train']) == 4

    def test_digits_without_sklearn_says_so(self, monkeypatch):
        import builtins
        real_import = builtins.__import__

        def no_sklearn(name, *args, **kwargs):
            if name.startswith('sklearn'):
                raise ImportError('no sklearn here')
            return real_import(name, *args, **kwargs)
        monkeypatch.setattr(builtins, '__import__', no_sklearn)
        with pytest.raises(ImportError, match='scikit-learn'):
            port_data.create_dataset('digits')


class TestDeviceData:
    @pytest.mark.parametrize('x', [
        np.random.RandomState(0).rand(4, 3, 3, 2).astype(np.float32),
        np.random.RandomState(1).randint(0, 256, (3, 2, 2, 1)).astype(
            np.uint8),
        np.random.RandomState(2).randn(3, 4).astype(np.float32),
        np.arange(6, dtype=np.int32)])
    def test_quantize_is_jax_s(self, x):
        got, got_dq = port_device_data.quantize_dataset(x)
        want, want_dq = jax_device_data.quantize_dataset(x)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got_dq == want_dq

    def test_augment_spec_is_jax_s(self):
        for spec in (['hflip', {'name': 'pad_crop', 'pad': 2}],
                     ['hflip', 'rotate'], None):
            assert port_device_data.normalize_augment_spec(spec) == \
                jax_device_data.normalize_augment_spec(spec)

    def _batch(self, n=16, hw=8):
        rng = np.random.RandomState(5)
        return torch.from_numpy(rng.randint(1, 256, (n, hw, hw, 3)).astype(
            np.uint8))

    def _run(self, augments, x, seed=0):
        fn = port_device_data.make_device_augment(augments, x.shape[1:])
        return fn(x, torch.Generator().manual_seed(seed))

    def test_pad_crop_is_a_window_of_the_reflect_padded_image(self):
        """A crop is a window of the image padded as the JAX package pads
        it (``jnp.pad(..., mode='reflect')``), at one offset per image."""
        x = self._batch()
        out = self._run([('pad_crop', {'pad': 2})], x)
        padded = np.pad(x.numpy(), ((0, 0), (2, 2), (2, 2), (0, 0)),
                        mode='reflect')
        offsets = set()
        for i in range(len(x)):
            hits = [(dy, dx) for dy in range(5) for dx in range(5)
                    if np.array_equal(out[i].numpy(),
                                      padded[i, dy:dy + 8, dx:dx + 8])]
            assert hits, i
            offsets.add(hits[0])
        assert len(offsets) > 1 and out.dtype == torch.uint8

    @pytest.mark.parametrize('name,axis', [('hflip', 2), ('vflip', 1)])
    def test_flips_are_exact(self, name, axis):
        x = self._batch()
        out = self._run([(name, {'p': 0.5})], x)
        flipped = [torch.equal(out[i], x[i].flip(axis - 1))
                   for i in range(len(x))]
        kept = [torch.equal(out[i], x[i]) for i in range(len(x))]
        assert all(f or k for f, k in zip(flipped, kept))
        assert any(flipped) and any(kept)
        assert torch.equal(self._run([(name, {'p': 1.0})], x),
                           x.flip(axis))

    def test_cutout_zeroes_one_window(self):
        x = self._batch()
        out = self._run([('cutout', {'size': 4, 'p': 1.0})], x)
        for i in range(len(x)):
            zero = (out[i] == 0).all(-1)
            assert 0 < int(zero.sum()) <= 16
            kept = ~zero
            assert torch.equal(out[i][kept], x[i][kept])

    def test_same_seed_same_batch(self):
        x = self._batch()
        augs = [('pad_crop', {'pad': 4}), ('hflip', {}), ('vflip', {}),
                ('cutout', {})]
        assert torch.equal(self._run(augs, x, 7), self._run(augs, x, 7))
        assert not torch.equal(self._run(augs, x, 7), self._run(augs, x, 8))

    def test_device_step_reseeds_its_augment_every_step(self):
        """One generator serves the run, reseeded every step: a step's
        crops and flips follow from its step count alone."""
        x = self._batch(n=8)
        y = torch.arange(8) % 10
        model = create_model(**_spec('batch'), device='cpu')
        opt = port_optim.make_optimizer({'name': 'sgd', 'lr': 0.1}, 10)[0]
        state = port_loop.create_train_state(model, opt)
        fn = port_device_data.make_device_augment(
            [('pad_crop', {'pad': 2}), ('hflip', {})], x.shape[1:])
        seen = []

        def augment(batch, gen):
            seen.append(fn(batch, gen))
            return seen[-1]
        step = port_loop.make_device_train_step(
            model, opt, port_loop.softmax_ce, augment=augment,
            dequantize=True)
        for _ in range(2):
            step(state, x, y, torch.arange(8))
        state.step = 0
        step(state, x, y, torch.arange(8))
        assert torch.equal(seen[0], seen[2])
        assert not torch.equal(seen[0], seen[1])

    def test_device_train_step_gathers_and_dequantizes(self):
        spec = _spec('batch')
        x = (np.random.RandomState(0).rand(12, 8, 8, 3)).astype(np.float32)
        y = np.arange(12, dtype=np.int32) % 10
        xq, dq = port_device_data.quantize_dataset(x)
        x_all, y_all = port_device_data.place_dataset(xq, y, 'cpu')
        idx = torch.tensor([3, 0, 7, 7])
        models = [create_model(**spec, device='cpu') for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        opts = [port_optim.make_optimizer({'name': 'sgd', 'lr': 0.1}, 10)[0]
                for _ in models]
        states = [port_loop.create_train_state(m, o)
                  for m, o in zip(models, opts)]
        dev = port_loop.make_device_train_step(models[0], opts[0],
                                               port_loop.softmax_ce,
                                               dequantize=dq)
        host = port_loop.make_train_step(models[1], opts[1],
                                         port_loop.softmax_ce)
        _, m_dev = dev(states[0], x_all, y_all, idx)
        _, m_host = host(states[1], torch.from_numpy(xq[idx.numpy()]).float()
                         / 255.0, torch.from_numpy(y[idx.numpy()]))
        assert float(m_dev['loss']) == float(m_host['loss'])


# ---------------------------------------------------------------- executor
EXEC_MODEL = _spec('fused')


def _config(tmp_path, **over):
    spec = {'type': 'train', 'model': dict(EXEC_MODEL),
            'dataset': {'name': 'synthetic_images', 'n_train': 48,
                        'n_valid': 16, 'image_size': 8},
            'loss': 'softmax_ce', 'batch_size': 16, 'mesh': {'dp': -1},
            'augment': ['hflip', {'name': 'pad_crop', 'pad': 2}],
            'stages': [{'name': 's1', 'epochs': 2, 'optimizer': {
                'name': 'adamw', 'lr': 1e-2,
                'schedule': {'name': 'warmup_cosine'}}}],
            'checkpoint_dir': str(tmp_path / 'ck'), 'model_name': 'cifar',
            'device': 'cpu', **over}
    return {'executors': {'train': spec}}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_executor(tmp_path, epochs=2, **over):
    log = logging.getLogger(f'test_resnet_{id(tmp_path)}')
    log.setLevel(logging.INFO)
    lines = _Lines()
    log.addHandler(lines)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = _config(tmp_path, **over)
        cfg['executors']['train']['stages'][0]['epochs'] = epochs
        result = Executor.from_config('train', cfg)(logger=log)
    finally:
        os.chdir(cwd)
        log.removeHandler(lines)
    return result, lines.lines


class TestExecutor:
    def test_trains_resumes_and_exports_for_jax(self, tmp_path):
        from flax import serialization
        from mlcomp_tpu.train.export import load_export
        from mlcomp_tpu_torch.train.export import make_predictor
        _, lines = _run_executor(tmp_path, epochs=1)
        assert any('device_data=True' in line for line in lines)
        result, lines = _run_executor(tmp_path, epochs=2)
        assert any('resumed from checkpoint' in line for line in lines)
        assert sum(' train {' in line for line in lines) == 1
        assert np.isfinite(result['best_score'])
        with open(tmp_path / 'ck' / 'last.msgpack', 'rb') as fh:
            raw = serialization.msgpack_restore(fh.read())
        assert raw['step'] == 6
        assert raw['batch_stats']['norm_stem']['var'].shape == (8,)
        export = str(tmp_path / 'models' / 'cifar')
        x = _images(5, seed=9)
        got = make_predictor(export, device='cpu', batch_size=2)(x)
        # the JAX package reads the port's export, statistics included,
        # and computes the same logits
        variables, spec = load_export(export)
        assert spec == EXEC_MODEL and 'batch_stats' in variables
        want = np.asarray(jax_create_model(**spec).apply(variables, x))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    def test_host_pipeline_without_augment(self, tmp_path):
        result, lines = _run_executor(tmp_path, epochs=1, augment=None,
                                      device_data=False)
        assert any('device_data=False' in line for line in lines)
        assert np.isfinite(result['best_score'])

    def test_host_augment_is_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError, match='A7'):
            _run_executor(tmp_path, epochs=1, device_data=False)

    def test_device_data_true_needs_device_augments(self, tmp_path):
        with pytest.raises(ValueError, match='device-expressible'):
            _run_executor(tmp_path, epochs=1, device_data=True,
                          augment=['rotate'])

    def test_every_device_mesh_raises_with_several_cards(self, tmp_path,
                                                         monkeypatch):
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
        with pytest.raises(NotImplementedError, match='A4'):
            Executor.from_config('train', _config(tmp_path))
        monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
        Executor.from_config('train', _config(tmp_path))

    def test_cifar_example_runs_with_type_and_norm_changed(self):
        """``examples/cifar_simple/config.yml``'s train executor builds
        with only ``type`` and the model's ``norm`` changed."""
        import yaml
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(here, 'examples', 'cifar_simple',
                               'config.yml')) as fh:
            config = yaml.safe_load(fh)
        spec = config['executors']['train']
        spec['type'] = 'train'
        spec['model']['norm'] = 'fused'
        ex = Executor.from_config('train', config)
        assert ex.device_data == 'auto' and ex.model_spec['norm'] == 'fused'


def test_host_copy_is_not_a_view_of_the_model():
    """The checkpoint's host copy, taken before the next step updates
    the weights in place, keeps its values on a CPU model too."""
    from mlcomp_tpu_torch.convert import variables_to_jax
    model = create_model(**_spec('batch'), device='cpu')
    variables = variables_to_jax(model)
    bias = np.array(variables['params']['head']['bias'])
    var = np.array(variables['batch_stats']['norm_stem']['var'])
    with torch.no_grad():
        model.head.bias.add_(1.0)
        model.norm_stem.var.add_(1.0)
    np.testing.assert_array_equal(variables['params']['head']['bias'], bias)
    np.testing.assert_array_equal(
        variables['batch_stats']['norm_stem']['var'], var)

"""The port's ViT classifier against the JAX package's, on the CPU.

Images come from numpy seeds and JAX initialises the weights, which
cross to the port through ``convert``; comparisons are at f32. JAX's
attention at 64 patches does not tile for its Pallas kernel, so both
sides run their plain attention here (on the card the port runs the
CUDA flash kernels' non-causal branch: ``chip_smoke.py``'s
``[vit-train]`` and ``kernel_check``'s ViT shape). Also held here: the
kernel checks' ViT shape and the faults planted at it.
"""

import ast
import dataclasses
import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.train import optim as jax_optim
from mlcomp_tpu_torch.convert import (
    input_shape_from_params, state_dict_from_jax,
    variables_to_jax, vit_params_from_jax, vit_params_to_jax,
)
from mlcomp_tpu_torch.models import create_model, model_names, param_count
from mlcomp_tpu_torch.models.vit import ViT
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense
from mlcomp_tpu_torch.testing import kernel_check, kernel_faults
from mlcomp_tpu_torch.train import export as port_export
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train import optim as port_optim
from mlcomp_tpu_torch.worker.executors import Executor

#: f32 on both sides: the same math in another summation order
#: (measured: logits 2.5e-7 relative L2)
F32_REL = 1e-5
#: f32 loss and gradients (measured: loss 8.3e-8, the worst
#: parameter's gradient 3.4e-7 relative L2) and one SGD step
GRAD_REL = 1e-4

SPEC = {'name': 'vit', 'num_classes': 10, 'image_size': 32,
        'patch_size': 4, 'd_model': 64, 'n_layers': 2, 'n_heads': 4,
        'd_ff': 128, 'dtype': 'float32'}


def _images(b, seed=0, size=32, channels=3):
    return np.random.RandomState(seed).rand(b, size, size, channels) \
        .astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_params(spec, x, seed=0):
    variables = jax_create_model(**spec).init(jax.random.PRNGKey(seed),
                                              x[:1])
    return jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))


def _port_model(spec, params, **kw):
    model = create_model(**spec, device='cpu', **kw)
    model.load_state_dict(vit_params_from_jax(params))
    return model


@pytest.fixture(scope='module')
def vit_both():
    x = _images(3)
    params = _jax_params(SPEC, x)
    return params, _port_model(SPEC, params)


class TestForward:
    def test_f32_logits_match_jax(self, vit_both):
        params, model = vit_both
        x = _images(3, seed=1)
        want = np.asarray(jax_create_model(**SPEC).apply(
            {'params': params}, x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (3, 10)
        assert _rel(got.numpy(), want) < F32_REL

    def test_bf16_logits_match_jax(self):
        """bf16 activations: each framework rounds at its own places
        (measured: 0.32% of the largest logit, every top-1 the same)."""
        spec = {**SPEC, 'dtype': 'bfloat16'}
        x = _images(8, seed=2)
        params = _jax_params(spec, x)
        want = np.asarray(jax_create_model(**spec).apply(
            {'params': params}, x), np.float32)
        with torch.no_grad():
            got = _port_model(spec, params)(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 7 / 8

    def test_non_causal_features(self, vit_both):
        """``tests/test_models.py``'s feature test on the port: patch 0's
        last-layer features depend on the LAST patch under the ViT's
        bidirectional attention and not under a causal stack with the
        same weights; the bidirectional features are JAX's."""
        params, model = vit_both
        x = _images(2)
        x2 = x.copy()
        x2[:, 28:, 28:, :] = 0.0        # only the last patch changes

        def features(m, inputs):
            seen = {}
            hook = m.layers[-1].register_forward_hook(
                lambda mod, args, out: seen.setdefault('x', out[0]))
            with torch.no_grad():
                m(torch.from_numpy(inputs))
            hook.remove()
            assert seen['x'].shape == (2, 64, 64)
            return seen['x'].numpy()

        causal = ViT(dataclasses.replace(model.cfg, causal=True),
                     num_classes=10)
        causal.load_state_dict(model.state_dict())
        bi = features(model, x) - features(model, x2)
        ca = features(causal, x) - features(causal, x2)
        assert np.abs(bi[:, 0]).max() > 1e-6
        np.testing.assert_allclose(ca[:, 0], 0, atol=1e-6)

        _, state = jax_create_model(**SPEC).apply(
            {'params': params}, x,
            capture_intermediates=lambda mdl, name: name == '__call__')
        want = np.asarray(state['intermediates']['layer_1']['__call__'][0])
        assert _rel(features(model, x), want) < F32_REL

    def test_defaults_are_jax_s(self):
        x = _images(1)
        jax_params = _jax_params({'name': 'vit', 'num_classes': 10}, x)
        model = create_model('vit', num_classes=10, device='cpu')
        assert param_count(model) == sum(
            np.size(a) for a in jax.tree.leaves(jax_params))
        assert len(model.layers) == 6 and model.cfg.d_model == 192
        assert model.cfg.n_heads == 3 and model.cfg.d_ff == 768
        assert model.cfg.max_seq_len == 64 and model.cfg.causal is False
        assert 'vit' in model_names()


class TestErrors:
    """The three ValueErrors, with JAX's messages."""

    def test_patch_not_dividing_the_image(self):
        spec = {**SPEC, 'patch_size': 5}
        with pytest.raises(ValueError, match='not divisible'):
            jax_create_model(**spec).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3)))
        model = create_model(**spec, device='cpu')
        with pytest.raises(ValueError, match='not divisible'):
            model(torch.zeros((1, 32, 32, 3)))

    def test_resolution_mismatch(self, vit_both):
        with pytest.raises(ValueError, match='image_size/patch_size'):
            jax_create_model(**SPEC).apply(
                {'params': vit_both[0]}, jnp.zeros((1, 16, 16, 3)))
        with pytest.raises(ValueError, match='image_size/patch_size'):
            vit_both[1](torch.zeros((1, 16, 16, 3)))

    def test_scan_layers_true(self):
        spec = {**SPEC, 'scan_layers': True}
        with pytest.raises(ValueError, match='scan_layers'):
            jax_create_model(**spec).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3)))
        with pytest.raises(ValueError, match='scan_layers'):
            create_model(**spec, device='cpu')


class TestTrainStep:
    def test_loss_and_gradients_match_jax(self, vit_both):
        params, model = vit_both
        x = _images(4, seed=3)
        y = np.random.RandomState(3).randint(0, 10, 4).astype(np.int32)
        jmodel = jax_create_model(**SPEC)

        def loss_fn(p):
            return jax_loop.softmax_ce(jmodel.apply({'params': p}, x), y)[0]

        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        want = vit_params_from_jax(jax.tree.map(np.asarray, jgrads))
        loss, _ = port_loop.softmax_ce(
            model(torch.from_numpy(x), train=True), torch.from_numpy(y))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert float(loss.detach()) == pytest.approx(float(jloss),
                                                     rel=GRAD_REL)
        for (name, _), g in zip(model.named_parameters(), grads):
            assert _rel(g.numpy(), want[name].numpy()) < GRAD_REL, name

    def test_one_sgd_step_matches_jax(self):
        x = _images(4, seed=4)
        y = np.random.RandomState(4).randint(0, 10, 4).astype(np.int32)
        opt_spec = {'name': 'sgd', 'lr': 0.1}
        jmodel = jax_create_model(**SPEC)
        jopt, _ = jax_optim.make_optimizer(opt_spec, 10)
        jstate = jax_loop.create_train_state(jmodel, jopt, x,
                                             jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, nn.meta.unbox(jstate.params))
        jstate, jm = jax_loop.make_train_step(jmodel, jopt,
                                              jax_loop.softmax_ce)(
            jstate, x, y)
        model = _port_model(SPEC, params)
        popt, _ = port_optim.make_optimizer(opt_spec, 10)
        pstate = port_loop.create_train_state(model, popt)
        pstate, pm = port_loop.make_train_step(model, popt,
                                               port_loop.softmax_ce)(
            pstate, torch.from_numpy(x), torch.from_numpy(y))
        assert set(pm) == set(jm) == {'loss', 'accuracy'}
        assert float(pm['loss']) == pytest.approx(float(jm['loss']),
                                                  rel=GRAD_REL)
        want = vit_params_from_jax(jax.tree.map(
            np.asarray, nn.meta.unbox(jstate.params)))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=GRAD_REL, err_msg=name)

    def test_remat_and_dropout_take_effect_in_train_mode(self, vit_both):
        params, model = vit_both
        x = torch.from_numpy(_images(2, seed=5))
        remat = _port_model({**SPEC, 'remat': True}, params)
        torch.testing.assert_close(remat(x, train=True), model(x, train=True))
        drop = _port_model({**SPEC, 'dropout': 0.5}, params)
        with torch.no_grad():
            torch.testing.assert_close(drop(x), model(x))
            a = drop(x, train=True, generator=torch.Generator().manual_seed(1))
        assert not torch.allclose(a, model(x))


class TestConverter:
    def test_round_trip_both_ways(self, vit_both):
        params, model = vit_both
        back = vit_params_to_jax(vit_params_from_jax(params), n_heads=4)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        tree = variables_to_jax(model)['params']
        assert set(tree) == {'patch_embed', 'pos_embed', 'layer_0',
                             'layer_1', 'norm_final', 'head'}
        sd = state_dict_from_jax({'params': tree}, 'vit')
        assert all(torch.equal(sd[k], v)
                   for k, v in model.state_dict().items())
        assert tree['patch_embed']['kernel'].shape == (48, 64)
        assert tree['head']['kernel'].shape == (64, 10)

    def test_unknown_leaves_raise(self, vit_both):
        params = dict(vit_both[0], extra={'kernel': np.zeros(2)})
        with pytest.raises(ValueError, match='leaves'):
            vit_params_from_jax(params)

    def test_input_shape_from_the_patch_projection(self, vit_both):
        assert input_shape_from_params('vit', vit_both[0], SPEC) == (
            None, None, 3)
        params = _jax_params({**SPEC, 'patch_size': 8},
                             _images(1, channels=1))
        assert input_shape_from_params(
            'vit', params, {**SPEC, 'patch_size': 8}) == (None, None, 1)


def _row_error(got, want):
    got = got.reshape(-1, got.shape[-1]).astype(np.float64)
    want = want.reshape(-1, want.shape[-1]).astype(np.float64)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


class TestExport:
    def test_int8_quantizes_what_jax_quantizes(self, tmp_path):
        """The MLP projections of every layer (64 × 1024 ≥ 65,536); not
        ``patch_embed``, attention's 3-D/4-D kernels or the head."""
        spec = {**SPEC, 'd_ff': 1024}
        x = _images(3, seed=6)
        variables = jax_create_model(**spec).init(jax.random.PRNGKey(0), x)
        path = jax_export.export_model(str(tmp_path / 'vit'),
                                       variables['params'], spec,
                                       meta={'input_shape': [32, 32, 3]})
        n_jax = jax_export._quantized_interceptor(
            jax_export.load_export(path)[0]['params'])[1]
        predict = port_export.make_predictor(file=path, batch_size=2,
                                             quantize='int8', device='cpu')
        swapped = sorted(n for n, m in predict.model.named_modules()
                         if isinstance(m, Int8Dense))
        assert predict.quantized == n_jax == 6
        assert swapped == sorted(f'layers.{i}.mlp.{p}' for i in range(2)
                                 for p in ('wi_gate', 'wi_up', 'wo'))
        want = jax_export.make_predictor(file=path, batch_size=2,
                                         quantize='int8')(x)
        # f32 activations: the same int8 weights, another summation
        # order (measured row error 8.9e-6)
        assert _row_error(predict(x), want) <= 1e-4
        plain = port_export.make_predictor(file=path, batch_size=2,
                                           device='cpu')(x)
        want_plain = jax_export.make_predictor(file=path, batch_size=2)(x)
        assert _rel(plain, want_plain) < F32_REL


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


class TestExecutor:
    def test_one_epoch_trains_and_exports(self, tmp_path):
        """``encoder_grid``'s ViT cell at a small width: its model keys
        (``cifar_stem`` included, which ViT ignores as JAX's does) on
        ``synthetic_images`` for one epoch; the export is JAX's."""
        spec = {'type': 'train',
                'model': {'name': 'vit', 'num_classes': 10,
                          'cifar_stem': True, 'dtype': 'float32',
                          'd_model': 32, 'n_layers': 1, 'n_heads': 2,
                          'd_ff': 64},
                'dataset': {'name': 'synthetic_images', 'n_train': 64,
                            'n_valid': 16, 'image_size': 32, 'channels': 3,
                            'num_classes': 10},
                'batch_size': 16, 'mesh': {'dp': -1},
                'main_metric': 'accuracy',
                'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                    'name': 'adamw', 'lr': 1e-3,
                    'schedule': {'name': 'warmup_cosine'}}}],
                'checkpoint_dir': str(tmp_path / 'ck'), 'model_name': 'vit',
                'device': 'cpu'}
        log = logging.getLogger(f'test_vit_{id(tmp_path)}')
        log.setLevel(logging.INFO)
        lines = _Lines()
        log.addHandler(lines)
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            result = Executor.from_config(
                'train', {'executors': {'train': spec}})(logger=log)
        finally:
            os.chdir(cwd)
            log.removeHandler(lines)
        train = [ast.literal_eval(line.split(' train ')[1].split(
            ' valid ')[0]) for line in lines.lines if ' train {' in line]
        assert len(train) == 1 and np.isfinite(train[0]['loss'])
        assert 0.0 <= result['best_score'] <= 1.0
        export = str(tmp_path / 'models' / 'vit')
        variables, jspec = jax_export.load_export(export)
        x = _images(3, seed=7)
        got = port_export.make_predictor(export, device='cpu',
                                         batch_size=2)(x)
        want = np.asarray(jax_create_model(**jspec).apply(variables, x))
        assert _rel(got, want) < F32_REL


class TestKernelChecks:
    VIT = (256, 64, 3, 64, torch.bfloat16, False)

    def test_vit_shape_is_held_forward_and_backward(self):
        assert self.VIT in kernel_check.ATTENTION_SHAPES
        assert self.VIT in kernel_check.BACKWARD_SHAPES
        assert kernel_check.VIT_SHAPE == self.VIT

    def test_vit_inference_shape_is_held_forward(self):
        """``infer_classify`` of the ViT at Equation.infer's batch of 512
        runs the forward alone, under the forward's bound."""
        want = (512, 64, 3, 64, torch.bfloat16, False)
        assert kernel_check.VIT_INFER_SHAPE == want
        assert want in kernel_check.ATTENTION_SHAPES
        assert want not in kernel_check.BACKWARD_SHAPES
        assert kernel_check.backward_head_tol(want) == \
            kernel_check.BACKWARD_HEAD_TOL[torch.bfloat16]

    def test_only_the_vit_shape_takes_its_own_head_bound(self):
        """Heads are measured one by one at every shape; VIT_HEAD_TOL
        holds at VIT_SHAPE only."""
        for shape in kernel_check.BACKWARD_SHAPES:
            want = kernel_check.VIT_HEAD_TOL if shape == self.VIT \
                else kernel_check.BACKWARD_HEAD_TOL[shape[4]]
            assert kernel_check.backward_head_tol(shape) == want
        gen = torch.Generator().manual_seed(0)
        ref = torch.randn(32, 64, 3, 8, generator=gen)
        out = ref.clone()
        out[0, :, 0] *= 1.01            # one batch element's head 0, 1%
        assert kernel_check.head_relative_error(out, ref) == \
            pytest.approx(1e-2, rel=1e-4)
        grads = ('dq', 'dk', 'dv')
        r = {'finite': True, 'lse_err': 0.0,
             'row_err': dict.fromkeys(grads, 0.0),
             'head_err': dict.fromkeys(grads, 1.5e-3),
             'autograd_head_err': dict.fromkeys(grads, 0.0)}
        assert kernel_check.backward_ok(r, torch.bfloat16, self.VIT)
        assert not kernel_check.backward_ok(r, torch.bfloat16)
        assert not kernel_check.backward_ok(
            r, torch.bfloat16, kernel_check.BACKWARD_SHAPES[0])
        r['head_err']['dk'] = 2.5e-3
        assert not kernel_check.backward_ok(r, torch.bfloat16, self.VIT)
        assert set(kernel_faults.HEAD_BOUND_FAULTS) <= set(
            kernel_faults.BACKWARD_FAULTS)

    def test_the_vit_head_bound_catches_ds_not_rounded(self):
        """At VIT_SHAPE the plain backward with dS left unrounded before
        dS K and dSᵀ Q (the HEAD_BOUND_FAULTS' numerics) passes the row
        bound and fails VIT_HEAD_TOL, while the same rounding in another
        summation order (the head dim permuted) stays inside it."""
        from mlcomp_tpu_torch.ops import flash_attention as fa
        b, t, h, d, dtype, causal = self.VIT
        gen = torch.Generator().manual_seed(0)
        q, k, v = kernel_check.qkv_views(b, t, h, d, dtype, gen, 'cpu')
        do = torch.randn((b, t, h, d), generator=gen).to(dtype)
        out, lse = fa.reference_attention(q, k, v, causal=causal,
                                          with_lse=True)

        def backward(perm, round_ds):
            qp, kp, vp, dop, op = (x[..., perm] for x in (q, k, v, do, out))
            scale = d ** -0.5
            p = fa._scores(qp, kp, causal, scale).sub_(
                lse.float()[..., None]).exp_()
            ds = torch.einsum('bqhd,bkhd->bhqk', dop.float(), vp.float())
            ds = ds.sub_(fa.attention_delta(op, dop)[..., None]).mul_(p)
            if round_ds:
                ds = ds.to(dtype).float()
            inv = torch.argsort(perm)
            return [(torch.einsum(eq, ds, x.float()) * scale)[..., inv]
                    .to(dtype) for eq, x in (('bhqk,bkhd->bqhd', kp),
                                             ('bhqk,bqhd->bkhd', qp))]

        same = torch.arange(d)
        base = fa.reference_attention_backward(q, k, v, out, lse, do,
                                               causal=causal)[:2]
        assert all(torch.equal(x, y)
                   for x, y in zip(backward(same, True), base))
        tol = kernel_check.backward_head_tol(self.VIT)
        floor = kernel_check.BACKWARD_ROW_FLOOR * kernel_check._rms_row(
            base[0])

        def errors(got):
            return ([kernel_check.row_relative_error(g, r, floor)
                     for g, r in zip(got, base)],
                    [kernel_check.head_relative_error(g, r)
                     for g, r in zip(got, base)])

        rows, heads = errors(backward(same, False))
        assert max(rows) < kernel_check.BACKWARD_ROW_TOL[dtype]
        assert min(heads) > 1.2 * tol
        rows, heads = errors(backward(torch.randperm(d, generator=gen),
                                      True))
        assert max(rows) < kernel_check.BACKWARD_ROW_TOL[dtype]
        assert max(heads) < tol / 2

    @pytest.mark.parametrize('table,kernel', [
        ('NON_CAUSAL_FAULTS', 'flash_attention_fwd'),
        ('NON_CAUSAL_BACKWARD_FAULTS', 'flash_attention_bwd')])
    def test_non_causal_faults_edit_the_shipped_source_once(self, table,
                                                           kernel):
        with open(os.path.join(_build.CSRC_DIR, kernel + '.cu')) as fh:
            source = fh.read()
        faults = getattr(kernel_faults, table)
        assert faults
        for edits in faults.values():
            for old, new in edits:
                assert source.count(old) == 1 and new != old
                assert 'p.causal' in old and 'p.causal' not in new \
                    or 'p.T' in old and 'p.T' not in new

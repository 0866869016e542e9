"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy seeds and weights cross from JAX to the port with
``convert.params_from_jax``: the model's gradients (JAX's attention under
the Pallas interpreter), three optimizer steps, each optimizer and
schedule against optax, the datasets and resume arithmetic, checkpoints
(read back by flax) and the ``train`` executor end to end, with its
export served by the port and loaded by JAX. Tolerances are stated where
they are used.
"""

import ast
import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import checkpoint as jax_ckpt
from mlcomp_tpu.train import data as jax_data
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.train import optim as jax_optim
from mlcomp_tpu_torch.convert import params_from_jax
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.transformer import dropout
from mlcomp_tpu_torch.train import checkpoint as ckpt
from mlcomp_tpu_torch.train import data as port_data
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train import optim as port_optim
from mlcomp_tpu_torch.worker.executors import Executor

GRAD_SPEC = {'name': 'transformer_lm', 'vocab_size': 512, 'd_model': 128,
             'n_layers': 2, 'n_heads': 2, 'd_ff': 256, 'max_seq_len': 256,
             'attn_impl': 'interpret'}
#: f32 gradients: the same math in another summation order (measured
#: worst relative L2 error of a parameter's gradient 1.5e-6)
F32_GRAD_REL = 1e-5
#: bf16 activations: the frameworks round at different places (measured
#: worst cosine 0.99985)
BF16_GRAD_COSINE = 0.99


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int32)


def _jax_params(model, tokens, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), tokens[:1])
    return jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))


def _port_model(spec, params):
    model = create_model(**spec, device='cpu')
    model.load_state_dict(params_from_jax(params))
    return model


def _port_grads(model, tokens, **kw):
    loss, _ = port_loop.lm_ce(model(torch.from_numpy(tokens), train=True,
                                    **kw), torch.from_numpy(tokens))
    return loss, dict(zip((n for n, _ in model.named_parameters()),
                          torch.autograd.grad(loss, list(model.parameters()))))


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def grads_both(request):
    """(JAX loss, JAX grads in port naming, port loss, port grads, spec,
    params) for the 2-layer LM at T=256 in one dtype."""
    spec = {**GRAD_SPEC, 'dtype': request.param}
    tokens = _tokens(2, 256, 512)
    jmodel = jax_create_model(**spec)
    params = _jax_params(jmodel, tokens)

    def loss_fn(p):
        return jax_loop.lm_ce(jmodel.apply({'params': p}, tokens), tokens)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, grads = _port_grads(_port_model(spec, params), tokens)
    return (float(jloss), params_from_jax(jax.tree.map(np.asarray, jgrads)),
            float(loss.detach()), grads, spec, params)


class TestModelGradients:
    def test_lm_ce_gradients_match_jax(self, grads_both):
        jloss, jgrads, loss, grads, spec, _ = grads_both
        assert set(grads) == set(jgrads)
        if spec['dtype'] == 'float32':
            assert abs(loss - jloss) < 1e-5 * abs(jloss)
            for name, g in grads.items():
                w = jgrads[name].float()
                assert float((g - w).norm() / w.norm()) < F32_GRAD_REL, name
        else:
            assert abs(loss - jloss) < 1e-2 * abs(jloss)
            for name, g in grads.items():
                cos = torch.nn.functional.cosine_similarity(
                    g.flatten().float(), jgrads[name].flatten().float(),
                    dim=0)
                assert float(cos) >= BF16_GRAD_COSINE, name

    def test_remat_gives_the_same_gradients(self, grads_both):
        _, _, loss, grads, spec, params = grads_both
        tokens = _tokens(2, 256, 512)
        remat_loss, remat = _port_grads(
            _port_model({**spec, 'remat': True}, params), tokens)
        # the recompute sums in another order now and then (measured:
        # 2% of one f32 gradient's elements off by up to 7e-9)
        assert float(remat_loss) == pytest.approx(loss, rel=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(remat[name], g, rtol=1e-4, atol=1e-6)


SMALL = {'name': 'transformer_lm', 'vocab_size': 64, 'd_model': 32,
         'n_layers': 2, 'n_heads': 2, 'd_ff': 64, 'max_seq_len': 32,
         'dtype': 'float32'}


class TestTrainMode:
    def test_dropout_zero_train_is_eval(self):
        model = create_model(**SMALL, device='cpu')
        x = torch.from_numpy(_tokens(2, 32, 64))
        with torch.no_grad():
            torch.testing.assert_close(model(x, train=True), model(x),
                                       rtol=0, atol=0)

    def test_dropout_needs_a_generator(self):
        model = create_model(**{**SMALL, 'dropout': 0.1}, device='cpu')
        with pytest.raises(ValueError, match='generator'):
            model(torch.from_numpy(_tokens(1, 8, 64)), train=True)

    def test_dropout_masks_follow_the_generator(self):
        model = create_model(**{**SMALL, 'dropout': 0.3}, device='cpu')
        x = torch.from_numpy(_tokens(2, 32, 64))

        def run(seed):
            with torch.no_grad():
                return model(x, train=True,
                             generator=torch.Generator().manual_seed(seed))

        torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
        assert not torch.equal(run(1), run(2))
        with torch.no_grad():
            assert not torch.equal(run(1), model(x))

    def test_remat_redraws_the_same_masks(self):
        x = torch.from_numpy(_tokens(2, 32, 64))
        base = create_model(**{**SMALL, 'dropout': 0.3}, device='cpu')
        remat = create_model(**{**SMALL, 'dropout': 0.3, 'remat': True},
                             device='cpu')
        remat.load_state_dict(base.state_dict())
        _, want = _port_grads(base, x.numpy(),
                              generator=torch.Generator().manual_seed(5))
        _, got = _port_grads(remat, x.numpy(),
                             generator=torch.Generator().manual_seed(5))
        for name, g in want.items():
            torch.testing.assert_close(got[name], g, rtol=0, atol=0)

    def test_dropout_is_flax_dropout(self):
        """Kept values are divided by the keep rate, the rest are 0 (flax
        ``nn.Dropout``); the kept share is the keep rate."""
        x = torch.ones(200_000)
        y = dropout(x, 0.25, torch.Generator().manual_seed(0))
        kept = torch.tensor(1.0) / 0.75
        assert set(torch.unique(y).tolist()) == {0.0, float(kept)}
        assert abs(float((y > 0).float().mean()) - 0.75) < 0.01
        assert torch.equal(dropout(x, 0.0, None), x)
        assert not dropout(x, 1.0, torch.Generator()).any()


# ------------------------------------------------------------- optimizers
_PARAM_SHAPES = {'w': (6, 5), 'b': (5,), 'e': (3, 4, 2)}
_STEPS = 6

OPT_CASES = {
    'sgd': {'name': 'sgd', 'lr': 0.1},
    'sgd_nesterov_wd': {'name': 'sgd', 'lr': 0.05, 'momentum': 0.8,
                        'nesterov': True, 'weight_decay': 0.01},
    'adam': {'name': 'adam', 'lr': 1e-2, 'b1': 0.8, 'b2': 0.95},
    'adam_wd': {'name': 'adam', 'lr': 1e-2, 'weight_decay': 0.05},
    'adamw': {'name': 'adamw', 'lr': 3e-3, 'weight_decay': 0.1},
    'adamw_clip': {'name': 'adamw', 'lr': 3e-3, 'grad_clip': 0.5},
    'cosine': {'name': 'adam', 'lr': 1e-2,
               'schedule': {'name': 'cosine', 'decay_steps': 5,
                            'final_lr': 1e-3}},
    'warmup_cosine': {'name': 'adamw', 'lr': 1e-2, 'grad_clip': 1.0,
                      'schedule': {'name': 'warmup_cosine',
                                   'warmup_steps': 2, 'decay_steps': 5}},
    'onecycle': {'name': 'adam', 'lr': 1e-2,
                 'schedule': {'name': 'onecycle', 'init_lr': 1e-4}},
    'step': {'name': 'sgd', 'lr': 0.1,
             'schedule': {'name': 'step', 'boundaries': [2, 4],
                          'gammas': [0.5, 0.1]}},
    'step_default': {'name': 'sgd', 'lr': 0.1,
                     'schedule': {'name': 'step', 'decay_steps': 6}},
    'constant': {'name': 'adamw', 'lr': 1e-3,
                 'schedule': {'name': 'constant'}},
    'accum_2': {'name': 'adamw', 'lr': 1e-2, 'accum_steps': 2,
                'schedule': {'name': 'warmup_cosine', 'warmup_steps': 2,
                             'decay_steps': 6}},
}


def _grad_sequence(seed=0):
    rng = np.random.RandomState(seed)
    return [{n: rng.randn(*s).astype(np.float32) for n, s in
             _PARAM_SHAPES.items()} for _ in range(_STEPS)]


def _run_both(spec, dtype=np.float32, total_steps=_STEPS):
    rng = np.random.RandomState(1)
    init = {n: rng.randn(*s).astype(np.float32)
            for n, s in _PARAM_SHAPES.items()}
    jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdtype = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    jopt, jsched = jax_optim.make_optimizer(spec, total_steps)
    popt, psched = port_optim.make_optimizer(spec, total_steps)
    jparams = {n: jnp.asarray(a, jdtype) for n, a in init.items()}
    pparams = {n: torch.from_numpy(a).to(tdtype) for n, a in init.items()}
    jstate, pstate = jopt.init(jparams), popt.init(pparams)
    out = []
    for grads in _grad_sequence():
        jg = {n: jnp.asarray(a, jdtype) for n, a in grads.items()}
        pg = {n: torch.from_numpy(a).to(tdtype) for n, a in grads.items()}
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        upd, pstate = popt.update(pg, pstate, pparams)
        port_optim.apply_updates(pparams, upd)
        out.append(({n: np.asarray(jnp.asarray(v, jnp.float32))
                     for n, v in jparams.items()},
                    {n: v.float().numpy().copy() for n, v in pparams.items()}))
    schedules = [(float(jsched(i)), float(psched(i))) for i in range(8)]
    return out, schedules


class TestOptimizers:
    @pytest.mark.parametrize('case', sorted(OPT_CASES))
    def test_matches_optax(self, case):
        """f32 arithmetic in another order: parameters agree to 1e-6
        relative over six steps; the schedules to 1e-6."""
        steps, schedules = _run_both(OPT_CASES[case])
        for want, got in steps:
            for n in want:
                np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                           atol=1e-6)
        for want, got in schedules:
            assert got == pytest.approx(want, rel=1e-6, abs=1e-9)

    def test_bf16_masters_update_in_f32(self):
        """``master_dtype: bfloat16``: bf16 params, f32 moments; after
        each step the bf16 params agree within one bf16 rounding."""
        spec = {'name': 'adamw', 'lr': 1e-2, 'master_dtype': 'bfloat16',
                'accum_steps': 2}
        steps, _ = _run_both(spec, dtype='bfloat16')
        for want, got in steps:
            for n in want:
                np.testing.assert_allclose(got[n], want[n], rtol=2 ** -7,
                                           atol=1e-6)
        popt, _ = port_optim.make_optimizer(spec, _STEPS)
        state = popt.init({'w': torch.zeros(2, dtype=torch.bfloat16)})
        assert state['acc_grads']['w'].dtype == torch.float32

    @pytest.mark.parametrize('spec,total', [
        ({'name': 'adam', 'acum_steps': 2}, None),
        ({'name': 'sgd', 'b1': 0.9}, None),
        ({'name': 'rmsprop'}, None),
        ({'name': 'adam', 'schedule': {'name': 'cosine', 'warmup': 3}},
         None),
        ({'name': 'adam', 'schedule': {'name': 'linear'}}, None),
        ({'name': 'adam', 'accum_steps': 0}, None),
        ({'name': 'adam', 'accum_steps': 4}, 3),
    ])
    def test_same_value_errors_as_jax(self, spec, total):
        with pytest.raises(ValueError) as want:
            jax_optim.make_optimizer(spec, total)
        with pytest.raises(ValueError) as got:
            port_optim.make_optimizer(spec, total)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize('name', ['lamb', 'adafactor'])
    def test_lamb_and_adafactor_are_not_ported(self, name):
        """lamb and adafactor are ported (``tests/
        test_torch_port_int8_train.py`` holds them against optax); like
        JAX they take the common keys only and refuse adam's ``b1``."""
        with pytest.raises(ValueError) as want:
            jax_optim.make_optimizer({'name': name, 'b1': 0.9})
        with pytest.raises(ValueError) as got:
            port_optim.make_optimizer({'name': name, 'b1': 0.9})
        assert str(got.value) == str(want.value)
        opt, _ = port_optim.make_optimizer({'name': name, 'lr': 1e-2,
                                            'grad_clip': 1.0})
        params = {'w': torch.ones(3, 2)}
        updates, _ = opt.update({'w': torch.ones(3, 2)}, opt.init(params),
                                params)
        assert updates['w'].shape == (3, 2) and bool((updates['w'] < 0).all())

    def test_state_moves_between_host_and_device(self):
        opt, _ = port_optim.make_optimizer({'name': 'adamw'}, 10)
        state = opt.init({'w': torch.ones(3)})
        host = port_optim.state_to_host(state)
        assert host['0']['mu']['w'] is not state['0']['mu']['w']
        back = port_optim.state_to_device(
            {'count': np.int64(2), 'mu': {'w': np.ones(3, np.float32)},
             'none': None}, 'cpu')
        assert back['count'] == 2 and isinstance(back['count'], int)
        assert torch.is_tensor(back['mu']['w']) and back['none'] is None


class TestTrainStep:
    def test_three_adamw_steps_match_jax(self):
        """AdamW with warmup_cosine and grad_clip on a 2-layer f32 LM
        (plain attention on both sides): losses agree to 1e-5 relative and
        the parameters after three steps to 1e-5 absolute."""
        spec = {**SMALL, 'attn_impl': 'dense'}
        opt_spec = {'name': 'adamw', 'lr': 3e-3, 'grad_clip': 1.0,
                    'schedule': {'name': 'warmup_cosine', 'warmup_steps': 2,
                                 'decay_steps': 10}}
        batches = [_tokens(2, 32, 64, seed=s) for s in range(3)]
        jmodel = jax_create_model(**spec)
        jopt, _ = jax_optim.make_optimizer(opt_spec, 10)
        jstate = jax_loop.create_train_state(
            jmodel, jopt, batches[0], jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, nn.meta.unbox(jstate.params))
        jstep = jax_loop.make_train_step(jmodel, jopt, jax_loop.lm_ce,
                                         self_supervised=True)
        model = _port_model(spec, params)
        popt, _ = port_optim.make_optimizer(opt_spec, 10)
        pstate = port_loop.create_train_state(model, popt)
        pstep = port_loop.make_train_step(model, popt, port_loop.lm_ce,
                                          self_supervised=True)
        for x in batches:
            jstate, jm = jstep(jstate, x, None)
            pstate, pm = pstep(pstate, torch.from_numpy(x), None)
            assert float(pm['loss']) == pytest.approx(float(jm['loss']),
                                                      rel=1e-5)
        want = params_from_jax(jax.tree.map(np.asarray,
                                            nn.meta.unbox(jstate.params)))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
        assert pstate.step == 3 and int(jstate.step) == 3

    def test_eval_step_and_aggregate_match_jax(self):
        spec = {**SMALL, 'attn_impl': 'dense'}
        x = _tokens(3, 32, 64)
        jmodel = jax_create_model(**spec)
        params = _jax_params(jmodel, x)
        jopt, _ = jax_optim.make_optimizer({'name': 'adam'}, 10)
        jstate = jax_loop.TrainState(step=0, params=params,
                                     opt_state=jopt.init(params))
        w = np.array([1.0, 0.0, 1.0], np.float32)
        want = jax_loop.make_eval_step(jmodel, jax_loop.lm_ce,
                                       self_supervised=True)(
            jstate, x, None, jnp.asarray(w))
        model = _port_model(spec, params)
        state = port_loop.create_train_state(
            model, port_optim.make_optimizer({'name': 'adam'}, 10)[0])
        got = port_loop.make_eval_step(model, port_loop.lm_ce,
                                       self_supervised=True)(
            state, torch.from_numpy(x), None, torch.from_numpy(w))
        agg = port_loop.aggregate_metrics([got, got], weights=[1, 3])
        want_agg = jax_loop.aggregate_metrics([want, want], weights=[1, 3])
        for k in want_agg:
            assert agg[k] == pytest.approx(want_agg[k], rel=1e-5)

    @pytest.mark.parametrize('task', [
        'softmax_ce', 'lm_ce', 'seg_ce', {'name': 'lm_ce', 'z_loss': 1e-4},
        {'name': 'lm_ce', 'label_smoothing': 0.1, 'impl': 'dense'}])
    def test_losses_match_jax(self, task):
        rng = np.random.RandomState(0)
        if task == 'softmax_ce':
            logits, labels = rng.randn(8, 10), rng.randint(0, 10, 8)
        elif task == 'seg_ce':
            logits, labels = rng.randn(2, 4, 4, 3), rng.randint(0, 3, (2, 4, 4))
        else:
            logits, labels = rng.randn(2, 16, 40), rng.randint(0, 40, (2, 16))
        logits = logits.astype(np.float32)
        labels = labels.astype(np.int32)
        w = rng.rand(logits.shape[0]).astype(np.float32)
        for weights in (None, w):
            jl, jm = jax_loop.loss_for_task(task)(
                jnp.asarray(logits), jnp.asarray(labels),
                None if weights is None else jnp.asarray(weights))
            pl_, pm = port_loop.loss_for_task(task)(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if weights is None else torch.from_numpy(weights))
            assert float(pl_) == pytest.approx(float(jl), rel=1e-5)
            assert float(pm['accuracy']) == pytest.approx(
                float(jm['accuracy']), rel=1e-6)

    @pytest.mark.parametrize('task,exc', [
        ({'name': 'lm_ce', 'temperature': 2}, ValueError),
        ({'name': 'softmax_ce', 'z_loss': 1e-4}, ValueError),
        ('hinge', KeyError)])
    def test_same_loss_errors_as_jax(self, task, exc):
        with pytest.raises(exc) as want:
            jax_loop.loss_for_task(task)
        with pytest.raises(exc) as got:
            port_loop.loss_for_task(task)
        if exc is ValueError:
            assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- data
class TestData:
    def test_synthetic_lm_is_jax_s(self):
        kw = dict(n_train=12, n_valid=4, seq_len=20, vocab_size=50, seed=3)
        want = jax_data.create_dataset('synthetic_lm', **kw)
        got = port_data.create_dataset('synthetic_lm', **kw)
        for key in ('x_train', 'x_valid'):
            np.testing.assert_array_equal(got[key], want[key])
        assert got['y_train'] is None and got['y_valid'] is None

    def test_npz_split_is_jax_s(self, tmp_path):
        x = np.arange(40).reshape(10, 4).astype(np.int32)
        np.savez(tmp_path / 'd.npz', x=x, y=x)
        folds = np.array([0, 1] * 5)
        np.save(tmp_path / 'f.npy', folds)
        for extra in ({}, {'fold_path': str(tmp_path / 'f.npy'),
                           'fold': 1}):
            want = jax_data.create_dataset('npz', path=str(
                tmp_path / 'd.npz'), **extra)
            got = port_data.create_dataset('npz', path=str(
                tmp_path / 'd.npz'), **extra)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])

    @pytest.mark.parametrize('drop_last', [True, False])
    def test_iterate_batches_is_jax_s(self, drop_last):
        x = np.arange(23)
        y = np.arange(23) * 2
        want = list(jax_data.iterate_batches(
            x, y, 5, np.random.RandomState(7), drop_last=drop_last))
        got = list(port_data.iterate_batches(
            x, y, 5, np.random.RandomState(7), drop_last=drop_last))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)

    def test_prefetch_keeps_order_and_values(self):
        batches = [(np.full((2, 3), i, np.int32), None) for i in range(5)]
        out = list(port_data.prefetch_batches(iter(batches), 'cpu', depth=2))
        assert [int(x[0, 0]) for x, _ in out] == list(range(5))
        assert all(y is None and x.dtype == torch.int32 for x, y in out)

    @pytest.mark.parametrize('name', ['digits_segmentation'])
    def test_other_datasets_are_not_ported(self, name):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            port_data.create_dataset(name)

    @pytest.mark.parametrize('meta', [
        None, {}, {'stage': 'b', 'stage_epoch': 0},
        {'stage': 'b', 'stage_epoch': 1}, {'stage': 'a', 'stage_epoch': 2},
        {'stage': 'c', 'stage_epoch': 0}, {'stage': 'zz', 'stage_epoch': 1},
        {'stage': 'a'}])
    def test_resume_plan_is_jax_s(self, meta):
        stages = [{'name': 'a', 'epochs': 3}, {'name': 'b', 'epochs': 2},
                  {'name': 'c'}]
        assert ckpt.resume_plan(stages, meta) == \
            jax_ckpt.resume_plan(stages, meta)


# ------------------------------------------------------------ checkpoints
class TestCheckpoints:
    def _tree(self, value=1.0):
        return {'step': 3, 'rng': None,
                'params': {'w': np.full((2, 3), value, np.float32)},
                'opt_state': {'0': {'count': 3,
                                    'mu': {'w': torch.ones(2, 3)}}}}

    def test_round_trip(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), self._tree(),
                             {'stage': 's', 'epoch': 0})
        tree, meta = ckpt.restore_checkpoint(str(tmp_path))
        assert tree['step'] == 3 and tree['rng'] is None
        np.testing.assert_array_equal(tree['params']['w'],
                                      self._tree()['params']['w'])
        assert tree['opt_state']['0']['count'] == 3
        assert meta['stage'] == 's' and 'time' in meta
        assert ckpt.load_meta(str(tmp_path))['epoch'] == 0
        assert ckpt.checkpoint_exists(str(tmp_path), 'best') is None

    def test_torn_last_falls_back_to_best(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, self._tree(1.0), {'epoch': 0}, best=True)
        ckpt.save_checkpoint(d, self._tree(2.0), {'epoch': 1})
        with open(os.path.join(d, 'last.msgpack'), 'r+b') as fh:
            fh.truncate(40)
        tree, meta = ckpt.restore_checkpoint(d)
        assert float(tree['params']['w'][0, 0]) == 1.0
        assert meta['epoch'] == 0

    def test_unfitting_last_falls_back_to_best(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, self._tree(1.0), {'epoch': 0}, best=True)
        ckpt.save_checkpoint(d, {'other': 1}, {'epoch': 1})
        tree, _ = ckpt.restore_checkpoint(d, target=lambda t: t['params'])
        assert float(tree['w'][0, 0]) == 1.0

    def test_corrupt_meta_reads_as_absent(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), self._tree(), {'epoch': 0})
        with open(tmp_path / 'last.msgpack.meta.json', 'w') as fh:
            fh.write('{"epo')
        assert ckpt.load_meta(str(tmp_path)) is None

    def test_async_writer_surfaces_a_failed_save(self, tmp_path):
        writer = ckpt.AsyncCheckpointWriter()
        writer.submit(str(tmp_path), {'bad': object()}, {})
        with pytest.raises(TypeError):
            writer.wait()
        writer.submit(str(tmp_path), self._tree(), {'epoch': 0})
        writer.close()
        assert ckpt.checkpoint_exists(str(tmp_path))

    def test_flax_reads_the_port_checkpoint(self, tmp_path):
        """The ``params`` of a checkpoint the port's trainer writes are
        the JAX layout: flax's own reader gets the port's weights back."""
        from flax import serialization
        _run_executor(tmp_path, epochs=1)
        with open(tmp_path / 'ck' / 'last.msgpack', 'rb') as fh:
            raw = serialization.msgpack_restore(fh.read())
        model = create_model(**EXEC_MODEL, device='cpu')
        model.load_state_dict(params_from_jax(raw['params']))
        want = params_from_jax(raw['params'])
        for name, p in model.state_dict().items():
            assert torch.equal(p, want[name])
        assert raw['step'] == 8 and raw['params']['layers']['attn'][
            'qkv']['kernel'].shape == (1, 32, 3, 2, 16)


# ---------------------------------------------------------------- executor
EXEC_MODEL = {'name': 'transformer_lm', 'vocab_size': 64, 'd_model': 32,
              'n_layers': 1, 'n_heads': 2, 'd_ff': 64, 'max_seq_len': 32,
              'dtype': 'float32'}


def _config(tmp_path, **over):
    spec = {'type': 'train', 'model': dict(EXEC_MODEL),
            'dataset': {'name': 'synthetic_lm', 'n_train': 64, 'n_valid': 16,
                        'seq_len': 32, 'vocab_size': 64},
            'loss': 'lm_ce', 'batch_size': 8, 'main_metric': 'loss',
            'minimize': True,
            'stages': [{'name': 's1', 'epochs': 2, 'optimizer': {
                'name': 'adamw', 'lr': 1e-2,
                'schedule': {'name': 'warmup_cosine'}}}],
            'checkpoint_dir': str(tmp_path / 'ck'), 'model_name': 'lm',
            'device': 'cpu', **over}
    return {'executors': {'train': spec}}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_executor(tmp_path, epochs=2, **over):
    log = logging.getLogger(f'test_train_{id(tmp_path)}')
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


def _train_losses(lines):
    return [ast.literal_eval(line.split(' train ')[1].split(' valid ')[0])
            ['loss'] for line in lines if ' train {' in line]


class TestExecutor:
    def test_registered_as_train_and_trainable(self):
        from mlcomp_tpu_torch.train.executor import Train
        assert Executor.get('train') is Train
        assert Executor.is_trainable('train')
        assert Executor.is_trainable('jax_train')
        assert not Executor.is_trainable('split')

    def test_trains_checkpoints_and_exports(self, tmp_path):
        from mlcomp_tpu.models import create_model as jcreate
        from mlcomp_tpu.train.export import load_export
        from mlcomp_tpu_torch.train.export import make_predictor
        result, lines = _run_executor(tmp_path)
        losses = _train_losses(lines)
        assert len(losses) == 2 and losses[1] < losses[0]
        assert np.isfinite(result['best_score'])
        assert {'best.msgpack', 'last.msgpack'} <= set(
            os.listdir(tmp_path / 'ck'))
        export = str(tmp_path / 'models' / 'lm')
        x = _tokens(3, 32, 64, seed=9)
        predict = make_predictor(export, device='cpu', batch_size=2)
        got = predict(x)
        # the JAX package reads the port's export and computes the same
        variables, spec = load_export(export)
        assert spec == EXEC_MODEL
        want = np.asarray(jcreate(**spec).apply(variables, x))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_resumes_from_its_checkpoint(self, tmp_path):
        _run_executor(tmp_path, epochs=1)
        _, lines = _run_executor(tmp_path, epochs=2)
        assert any('resumed from checkpoint' in line for line in lines)
        assert len(_train_losses(lines)) == 1       # only epoch 1 ran

    def test_unknown_keys_are_logged(self, tmp_path):
        _, lines = _run_executor(tmp_path, epochs=1, lerning_rate=1)
        assert any('WARNING' in line and 'lerning_rate' in line
                   for line in lines)

    @pytest.mark.parametrize('key,value', [
        ('mesh', {'dp': 2}), ('epoch_scan', True),
        ('report_imgs', {'type': 'classification'})])
    def test_not_ported_keys_raise(self, tmp_path, key, value):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            Executor.from_config('train', _config(tmp_path, **{key: value}))

    def test_stage_per_dispatch_is_accepted(self, tmp_path):
        ex = Executor.from_config('train', _config(
            tmp_path, stage_per_dispatch=True))
        assert ex.stage_per_dispatch

    def test_report_imgs_refusal_names_the_encoder(self, tmp_path):
        with pytest.raises(NotImplementedError, match='OpenCV'):
            Executor.from_config('train', _config(
                tmp_path, report_imgs={'type': 'classification'}))

    def test_single_device_mesh_and_auto_data_are_accepted(self, tmp_path):
        Executor.from_config('train', _config(
            tmp_path, mesh={'dp': 1}, device_data='auto'))

    def test_runs_on_the_card_unless_asked_for_the_cpu(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip('a CUDA card is present')
        cfg = _config(tmp_path)
        del cfg['executors']['train']['device']
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Executor.from_config('train', cfg)()

    def test_a_db_session_is_not_ported(self, tmp_path):
        """Only sqlite is: a PostgreSQL session raises naming A0's
        second half."""
        from mlcomp_tpu_torch.db.core import Session
        with pytest.raises(NotImplementedError, match='A0'):
            Session.create_session(
                key='train-pg', connection_string='postgresql://u@h/db')

    def test_grid_cell_overrides_merge_into_the_spec(self, tmp_path):
        ex = Executor.from_config(
            'train', _config(tmp_path), additional_info={'grid': {
                'batch_size': 4, 'dataset': {'seq_len': 16}}})
        assert ex.batch_size == 4 and ex.dataset_spec['seq_len'] == 16

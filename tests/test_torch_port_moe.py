"""The port's MoE transformer LM against the JAX package's, on the CPU.

Inputs come from numpy seeds and JAX initialises the weights, which
cross to the port through ``convert``; every comparison is at f32. The
JAX side runs its modules' ``apply`` and the loop's step builders
directly (its trainer is not an oracle here: it aborts under xdist
inside ``aggregate_metrics``), with its attention under the Pallas
interpreter where the sequence tiles (T=128), its plain reference where
it does not.
"""

import ast
import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.models.transformer import MoeMlpBlock as JaxMoe
from mlcomp_tpu.models.transformer import TransformerConfig as JaxConfig
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu.train import layer_stack as jax_stack
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.train import optim as jax_optim
from mlcomp_tpu_torch.convert import (
    params_from_jax, params_to_jax, port_module_name, state_dict_from_jax,
    variables_to_jax,
)
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.transformer import MoeMlpBlock
from mlcomp_tpu_torch.models.transformer import TransformerConfig
from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense
from mlcomp_tpu_torch.train import export as port_export
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train import optim as port_optim
from mlcomp_tpu_torch.worker.executors import Executor

#: f32 on both sides: the same math in another summation order
#: (measured relative L2: block outputs <= 1.8e-7, logits 7.3e-7)
F32_REL = 1e-5
#: f32 loss and gradients (measured: loss 8.9e-8, the worst
#: parameter's gradient 1.0e-6 relative L2) and one SGD step
GRAD_REL = 1e-4
#: the load-balance loss: means of f32 probabilities in another order
#: (measured 1.2e-7 relative for one block, equal for the 4-layer LM)
AUX_REL = 1e-6

SPEC = {'name': 'transformer_lm', 'vocab_size': 128, 'd_model': 64,
        'n_layers': 4, 'n_heads': 4, 'd_ff': 128, 'max_seq_len': 128,
        'dtype': 'float32', 'n_experts': 4, 'moe_every': 2,
        'attn_impl': 'interpret'}


def _tokens(b, t, vocab=128, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_params(spec, tokens, seed=0):
    variables = jax_create_model(**spec).init(jax.random.PRNGKey(seed),
                                              tokens[:1])
    return jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))


def _port_model(spec, params):
    model = create_model(**spec, device='cpu')
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_aux(updates) -> float:
    """The summed sown ``moe_aux_loss`` of an apply's intermediates."""
    leaves = []

    def walk(tree):
        for key, value in tree.items():
            if key == 'moe_aux_loss':
                leaves.extend(jax.tree.leaves(value))
            elif isinstance(value, dict):
                walk(value)

    walk(updates['intermediates'])
    return float(sum(np.asarray(a, np.float32).sum() for a in leaves))


class TestMoeBlock:
    @pytest.mark.parametrize('capacity_factor', [0.5, 1.25, 4.0])
    def test_block_matches_jax(self, capacity_factor):
        """Output, aux and every token's expert at f32. At 0.5 each
        expert takes 4 of 32 tokens, so most overflow onto the residual
        path (a zero row); at 4.0 (a capacity of T) none can."""
        jcfg = JaxConfig(d_model=32, d_ff=64, n_experts=4, dtype='float32',
                         capacity_factor=capacity_factor)
        x = np.random.RandomState(3).randn(2, 32, 32).astype(np.float32)
        block = JaxMoe(jcfg)
        params = jax.tree.map(np.asarray, nn.meta.unbox(
            block.init(jax.random.PRNGKey(1), x)['params']))
        (want, updates) = block.apply(
            {'params': params}, x, mutable=['intermediates'],
            capture_intermediates=lambda mdl, name: mdl.name == 'router')
        logits = updates['intermediates']['router']['__call__'][0]
        want_choice = np.asarray(jnp.argmax(jax.nn.softmax(logits), -1))

        cfg = TransformerConfig(d_model=32, d_ff=64, n_experts=4,
                                dtype='float32',
                                capacity_factor=capacity_factor)
        port = MoeMlpBlock(cfg)
        port.load_state_dict({
            'router.weight': torch.from_numpy(
                np.ascontiguousarray(params['router']['kernel'].T)),
            'w_in': torch.tensor(params['w_in']),
            'w_out': torch.tensor(params['w_out'])})
        xt = torch.from_numpy(x)
        with torch.no_grad():
            got, aux = port(xt)
            choice = port.router(xt).softmax(-1).argmax(-1).numpy()
        np.testing.assert_array_equal(choice, want_choice)
        assert _rel(got.numpy(), want) < F32_REL
        assert float(aux) == pytest.approx(_jax_aux(updates), rel=AUX_REL)
        dropped = (np.abs(np.asarray(want)).sum(-1) == 0).sum()
        assert ((got.abs().sum(-1) == 0).sum().item()) == dropped
        if capacity_factor < 1:
            assert dropped > 0
        if capacity_factor >= 4:
            assert dropped == 0

    def test_aux_is_not_kept_on_the_module(self):
        cfg = TransformerConfig(d_model=16, d_ff=32, n_experts=2,
                                dtype='float32')
        block = MoeMlpBlock(cfg)
        with torch.no_grad():
            block.reset_parameters(torch.Generator().manual_seed(0))
            _, aux = block(torch.randn(1, 8, 16))
        assert aux.dtype == torch.float32 and aux.dim() == 0
        assert not any(torch.is_tensor(v) and v is aux
                       for v in vars(block).values())
        assert set(dict(block.named_parameters())) == {
            'router.weight', 'w_in', 'w_out'}


@pytest.fixture(scope='module')
def lm_both():
    """(JAX params, JAX logits, JAX aux, port model) of the 4-layer MoE
    LM at T=128."""
    tokens = _tokens(2, 128)
    params = _jax_params(SPEC, tokens)
    logits, updates = jax_create_model(**SPEC).apply(
        {'params': params}, tokens, mutable=['intermediates'])
    return params, np.asarray(logits), _jax_aux(updates), \
        _port_model(SPEC, params)


class TestMoeLM:
    def test_interleave_is_jax_s(self, lm_both):
        params, _, _, model = lm_both
        for i in range(SPEC['n_layers']):
            assert ('moe' in params[f'layer_{i}']) == hasattr(
                model.layers[i], 'moe') == (i % 2 == 1)

    def test_logits_and_aux_match_jax(self, lm_both):
        _, want, want_aux, model = lm_both
        with torch.no_grad():
            logits, aux = model(torch.from_numpy(_tokens(2, 128)),
                                return_aux=True)
            plain = model(torch.from_numpy(_tokens(2, 128)))
        assert _rel(logits.numpy(), want) < F32_REL
        torch.testing.assert_close(plain, logits, rtol=0, atol=0)
        assert float(aux) == pytest.approx(want_aux, rel=AUX_REL)

    def test_loss_and_gradients_match_jax_s_step(self, lm_both):
        """The loss JAX's train step differentiates (``_apply`` with the
        sown aux, + MOE_AUX_COEF · aux) against the port's step's."""
        params, _, _, model = lm_both
        tokens = _tokens(2, 128, seed=4)
        jmodel = jax_create_model(**SPEC)
        state = jax_loop.TrainState(step=0, params=params, opt_state=None)

        def loss_fn(p):
            logits, _, aux = jax_loop._apply(
                jmodel, state.replace(params=p), tokens, train=True)
            loss, _ = jax_loop.lm_ce(logits, tokens)
            return loss + jax_loop.MOE_AUX_COEF * aux

        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        want = params_from_jax(jax.tree.map(np.asarray, jgrads))
        logits, aux = port_loop._apply_train(
            model, torch.from_numpy(tokens), None)
        ce, _ = port_loop.lm_ce(logits, torch.from_numpy(tokens))
        loss = ce + port_loop.MOE_AUX_COEF * aux
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert port_loop.MOE_AUX_COEF == jax_loop.MOE_AUX_COEF
        assert float(loss.detach()) == pytest.approx(float(jloss),
                                                     rel=GRAD_REL)
        for (name, _), g in zip(model.named_parameters(), grads):
            assert _rel(g.numpy(), want[name].numpy()) < GRAD_REL, name
        assert any('moe.router' in n for n, _ in model.named_parameters())

    def test_one_sgd_step_matches_jax(self):
        """``make_train_step`` on both sides: the loss and ``moe_aux``
        metrics, and every parameter after the update (SGD, whose update
        is the gradient itself: Adam's first step divides each gradient
        by its own size, so an element near 0 moves by ±lr on noise)."""
        spec = {**SPEC, 'n_layers': 2, 'attn_impl': 'dense'}
        tokens = _tokens(2, 32, seed=5)
        opt_spec = {'name': 'sgd', 'lr': 0.1}
        jmodel = jax_create_model(**spec)
        jopt, _ = jax_optim.make_optimizer(opt_spec, 10)
        jstate = jax_loop.create_train_state(jmodel, jopt, tokens,
                                             jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, nn.meta.unbox(jstate.params))
        jstep = jax_loop.make_train_step(jmodel, jopt, jax_loop.lm_ce,
                                         self_supervised=True)
        jstate, jm = jstep(jstate, tokens, None)
        model = _port_model(spec, params)
        popt, _ = port_optim.make_optimizer(opt_spec, 10)
        pstate = port_loop.create_train_state(model, popt)
        pstep = port_loop.make_train_step(model, popt, port_loop.lm_ce,
                                          self_supervised=True)
        pstate, pm = pstep(pstate, torch.from_numpy(tokens), None)
        assert set(pm) == set(jm) == {'loss', 'accuracy', 'moe_aux'}
        for key in ('loss', 'moe_aux'):
            assert float(pm[key]) == pytest.approx(float(jm[key]),
                                                   rel=GRAD_REL)
        want = params_from_jax(jax.tree.map(np.asarray,
                                            nn.meta.unbox(jstate.params)))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=GRAD_REL, err_msg=name)

    def test_eval_step_reports_no_aux(self):
        spec = {**SPEC, 'n_layers': 2, 'attn_impl': 'dense'}
        model = create_model(**spec, device='cpu')
        state = port_loop.create_train_state(
            model, port_optim.make_optimizer({'name': 'adam'}, 10)[0])
        metrics = port_loop.make_eval_step(model, port_loop.lm_ce,
                                           self_supervised=True)(
            state, torch.from_numpy(_tokens(2, 32)), None)
        assert set(metrics) == {'loss', 'accuracy'}

    def test_remat_gives_the_same_loss_and_aux(self, lm_both):
        params = lm_both[0]
        tokens = torch.from_numpy(_tokens(1, 128, seed=2))
        plain = _port_model(SPEC, params)
        remat = _port_model({**SPEC, 'remat': True}, params)
        out = [m(tokens, train=True, return_aux=True) for m in (plain, remat)]
        torch.testing.assert_close(out[1][0], out[0][0])
        torch.testing.assert_close(out[1][1], out[0][1])
        g = [torch.autograd.grad(o[1], m.layers[1].moe.router.weight)[0]
             for o, m in zip(out, (plain, remat))]
        torch.testing.assert_close(g[1], g[0])


class TestConfig:
    def test_scan_layers_true_raises_as_jax_does(self):
        tokens = _tokens(1, 8)
        with pytest.raises(ValueError, match='homogeneous'):
            jax_create_model(**{**SPEC, 'scan_layers': True}).init(
                jax.random.PRNGKey(0), tokens)
        with pytest.raises(ValueError, match='homogeneous'):
            create_model(**{**SPEC, 'scan_layers': True}, device='cpu')

    @pytest.mark.parametrize('moe_every,want', [
        (1, [1, 1, 1, 1]), (2, [0, 1, 0, 1]), (3, [0, 0, 1, 0])])
    def test_moe_every(self, moe_every, want):
        model = create_model(**{**SPEC, 'moe_every': moe_every},
                             device='cpu')
        assert [int(hasattr(layer, 'moe')) for layer in model.layers] == want


class TestConverter:
    def test_round_trip_both_ways(self, lm_both):
        params, _, _, model = lm_both
        back = params_to_jax(params_from_jax(params), n_heads=4,
                             stacked=False)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        tree = variables_to_jax(model)['params']
        assert 'layer_1' in tree and 'layers' not in tree
        sd = params_from_jax(tree)
        assert sd.keys() == model.state_dict().keys()
        assert all(torch.equal(sd[k], v)
                   for k, v in model.state_dict().items())
        assert tree['layer_1']['moe']['router']['kernel'].shape == (64, 4)
        assert tree['layer_1']['moe']['w_in'].shape == (4, 64, 128)
        assert tree['layer_1']['moe']['w_out'].shape == (4, 128, 64)

    def test_boxed_tree_loads(self, lm_both):
        params, _, _, model = lm_both
        boxed = serialization.to_state_dict(jax_create_model(**SPEC).init(
            jax.random.PRNGKey(0), _tokens(1, 128))['params'])
        assert set(boxed['layer_1']['moe']['w_in']) == {'value'}
        sd = state_dict_from_jax({'params': boxed}, 'transformer_lm')
        assert all(torch.equal(sd[k], torch.from_numpy(np.asarray(v)))
                   for k, v in params_from_jax(params).items())

    def test_stacked_moe_is_refused(self, lm_both):
        params, _, _, model = lm_both
        with pytest.raises(ValueError, match='MoE'):
            params_to_jax(model.state_dict(), n_heads=4, stacked=True)
        # the JAX package's own stacker refuses the interleave
        with pytest.raises(ValueError, match='differ in structure'):
            jax_stack.stack_layer_tree(params)
        # every layer MoE is homogeneous, but JAX never scans experts
        uniform = {**params, **{f'layer_{i}': params['layer_1']
                                for i in range(4)}}
        with pytest.raises(ValueError, match='scan_layers'):
            params_from_jax(jax_stack.stack_layer_tree(uniform))

    def test_kernel_shapes_name_the_router(self, lm_both):
        from mlcomp_tpu_torch.convert import jax_kernel_shapes
        shapes = jax_kernel_shapes(lm_both[3])
        assert shapes['layers.1.moe.router.weight'] == (64, 4)
        assert 'layers.1.moe.w_in' not in shapes


def _row_error(got, want):
    got = got.reshape(-1, got.shape[-1]).astype(np.float64)
    want = want.reshape(-1, want.shape[-1]).astype(np.float64)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


class TestInt8Export:
    #: int8 weights on f32 activations: both packages quantize the same
    #: kernels bit for bit; the products sum in another order (measured
    #: row error 9.7e-7)
    ROW_TOL = 1e-4

    def test_quantizes_what_jax_quantizes(self, tmp_path):
        """JAX's rule (2-D kernels of ≥ 65,536 elements): the dense
        layers' MLP projections and the head; never the router [M, X] or
        the 3-D expert weights."""
        spec = {**SPEC, 'vocab_size': 1024, 'd_ff': 1024,
                'attn_impl': 'auto'}
        x = _tokens(3, 16, vocab=1024, seed=8)
        variables = jax_create_model(**spec).init(jax.random.PRNGKey(0), x)
        path = jax_export.export_model(str(tmp_path / 'moe'),
                                       variables['params'], spec)
        loaded, _ = jax_export.load_export(path)
        n_jax = jax_export._quantized_interceptor(loaded['params'])[1]
        want_names = sorted(port_module_name(p) for p in _jax_rerouted(
            jax_create_model(**spec), loaded, x))
        predict = port_export.make_predictor(file=path, batch_size=4,
                                             quantize='int8', device='cpu')
        swapped = sorted(n for n, m in predict.model.named_modules()
                         if isinstance(m, Int8Dense))
        assert predict.quantized == n_jax == len(want_names) == 7
        assert swapped == want_names
        assert not any('moe' in n for n in swapped)
        want = jax_export.make_predictor(file=path, batch_size=4,
                                         quantize='int8')(x)
        got = predict(x)
        assert _row_error(got, want) <= self.ROW_TOL


def _jax_rerouted(model, variables, x) -> set:
    """The module paths whose call JAX's ``_quantized_interceptor``
    reroutes through the int8 product (it never calls the module's own
    ``__call__`` there), from one eager apply."""
    interceptor, _ = jax_export._quantized_interceptor(variables['params'])
    rerouted = set()

    def spy(next_fun, args, kwargs, context):
        called = []

        def tracked(*a, **k):
            called.append(True)
            return next_fun(*a, **k)

        y = interceptor(tracked, args, kwargs, context)
        if not called:
            rerouted.add(tuple(context.module.path))
        return y

    with nn.intercept_methods(spy):
        model.apply(variables, jnp.asarray(x))
    return rerouted


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


EXEC_MODEL = {'name': 'transformer_lm', 'vocab_size': 64, 'd_model': 32,
              'n_layers': 2, 'n_heads': 2, 'd_ff': 64, 'max_seq_len': 32,
              'dtype': 'float32', 'n_experts': 4, 'moe_every': 2}


def _config(tmp_path, **over):
    spec = {'type': 'train', 'model': dict(EXEC_MODEL),
            'dataset': {'name': 'synthetic_lm', 'n_train': 64, 'n_valid': 16,
                        'seq_len': 32, 'vocab_size': 64},
            'loss': 'lm_ce', 'batch_size': 8, 'main_metric': 'loss',
            'minimize': True,
            'stages': [{'name': 's1', 'epochs': 1, 'optimizer': {
                'name': 'adamw', 'lr': 1e-2,
                'schedule': {'name': 'warmup_cosine'}}}],
            'checkpoint_dir': str(tmp_path / 'ck'), 'model_name': 'moe_lm',
            'device': 'cpu', **over}
    return {'executors': {'train': spec}}


class TestExecutor:
    def test_one_epoch_reports_moe_aux_and_exports(self, tmp_path):
        log = logging.getLogger(f'test_moe_{id(tmp_path)}')
        log.setLevel(logging.INFO)
        lines = _Lines()
        log.addHandler(lines)
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            result = Executor.from_config('train', _config(tmp_path))(
                logger=log)
        finally:
            os.chdir(cwd)
            log.removeHandler(lines)
        train = [ast.literal_eval(line.split(' train ')[1].split(
            ' valid ')[0]) for line in lines.lines if ' train {' in line]
        assert len(train) == 1 and 1.0 <= train[0]['moe_aux'] <= 4.0
        assert np.isfinite(result['best_score'])
        export = str(tmp_path / 'models' / 'moe_lm')
        variables, spec = jax_export.load_export(export)
        assert 'moe' in variables['params']['layer_1']
        x = _tokens(3, 32, vocab=64, seed=9)
        got = port_export.make_predictor(export, device='cpu',
                                         batch_size=2)(x)
        want = np.asarray(jax_create_model(**spec).apply(variables, x))
        assert _row_error(got, want) < F32_REL

    @pytest.mark.parametrize('mesh', [{'dp': -1, 'fsdp': 2, 'ep': 2},
                                      {'ep': 2}])
    def test_ep_mesh_is_refused_naming_a4(self, tmp_path, mesh):
        with pytest.raises(NotImplementedError, match='A4'):
            Executor.from_config('train', _config(tmp_path, mesh=mesh))

    def test_examples_moe_model_builds(self):
        """``examples/moe``'s model spec builds and runs in the port."""
        model = create_model(
            'transformer_lm', vocab_size=1024, d_model=128, n_layers=2,
            n_heads=4, d_ff=256, max_seq_len=256, dtype='bfloat16',
            n_experts=4, moe_every=2, device='cpu')
        with torch.no_grad():
            logits, aux = model(torch.from_numpy(_tokens(1, 64, 1024)),
                                return_aux=True)
        assert logits.shape == (1, 64, 1024) and torch.isfinite(aux)

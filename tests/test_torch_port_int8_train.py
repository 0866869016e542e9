"""The port's int8 training path against the JAX package's, on the CPU:
the per-channel quantizers, ``int8_train_matmul`` (forward, straight-
through gradients, what it saves), a 2-layer LM at ``matmul_precision:
int8`` with f32 and bf16 activations, checkpoints across precisions and
packages, the ``train`` executor with the fused-CE loss, the int8-
trained export served plain and with ``quantize='int8'``, and the
``lamb`` and ``adafactor`` optimizers against optax.

Inputs come from numpy seeds and go through both packages; tolerances
are stated where they are used.
"""

import ast
import importlib
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
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu.train import optim as jax_optim
from mlcomp_tpu.train.executor import JaxTrain
from mlcomp_tpu_torch.convert import (
    jax_kernel_shapes, params_from_jax, state_dict_from_jax,
    unwrap_value_nodes,
)
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.quant import Int8DenseGeneral
from mlcomp_tpu_torch.models.transformer import Dense
from mlcomp_tpu_torch.testing import kernel_check
from mlcomp_tpu_torch.train import checkpoint as port_ckpt
from mlcomp_tpu_torch.train import export as port_export
from mlcomp_tpu_torch.train import loop as port_loop
from mlcomp_tpu_torch.train import optim as port_optim
from mlcomp_tpu_torch.worker.executors import Executor

jax_int8 = importlib.import_module('mlcomp_tpu.ops.int8_matmul')
port_int8 = importlib.import_module('mlcomp_tpu_torch.ops.int8_matmul')

#: the int8 products are exact on both sides and the scales apply once in
#: f32: what differs is the f32 summation order over K ≤ 64
MATMUL_TOL = 1e-5
LM = {'name': 'transformer_lm', 'vocab_size': 256, 'd_model': 64,
      'n_layers': 2, 'n_heads': 4, 'd_ff': 128, 'max_seq_len': 16,
      'matmul_precision': 'int8', 'attn_impl': 'dense'}


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int32)


def _jax_params(spec, tokens, seed=0):
    variables = jax_create_model(**spec).init(jax.random.PRNGKey(seed),
                                              tokens[:1])
    return jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))


def _port_model(spec, params):
    model = create_model(**spec, device='cpu')
    model.load_state_dict(params_from_jax(params))
    return model


# ---------------------------------------------------------------- quantizer
def _with_halves_and_zeros(a: np.ndarray, axis: int) -> np.ndarray:
    """``a`` with its first channel along ``axis`` all zeros and its
    second holding 127 and values that land on .5 after dividing by the
    scale (1.0): round half to even decides them."""
    a = np.moveaxis(a.copy(), axis, 0)
    a[0] = 0.0
    a[1, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]
    a[1, 5:] = 0.25
    return np.moveaxis(a, 0, axis)


class TestQuantize:
    @pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
    def test_rows_bit_identical_to_jax(self, dtype):
        x = _with_halves_and_zeros(
            np.random.RandomState(0).randn(9, 40).astype(np.float32), 0)
        jx = jnp.asarray(x, dtype)
        want_q, want_s = jax_int8._quantize_rows(jx)
        got_q, got_s = port_int8._quantize_rows(
            torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
                getattr(torch, dtype)))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert list(got_q[1, :5]) == [127, 2, -4, 0, 0]
        assert float(got_s[0]) == 1.0 and not got_q[0].any()

    def test_cols_bit_identical_to_jax(self):
        w = _with_halves_and_zeros(
            (np.random.RandomState(1).randn(40, 12) * 0.05)
            .astype(np.float32), 1)
        want_q, want_s = jax_int8._quantize_cols(jnp.asarray(w))
        # per column of JAX's [K, N] kernel: _quantize_rows of its
        # transpose, transposed back
        got_q, got_s = port_int8._quantize_rows(torch.from_numpy(w).t())
        got_q = got_q.t()
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        # the port's [N, K] weight quantizes per row to the same values
        q_rows, s_rows = port_int8._quantize_rows(torch.from_numpy(w.T))
        np.testing.assert_array_equal(q_rows.numpy(), np.asarray(want_q).T)
        np.testing.assert_array_equal(s_rows.numpy(), np.asarray(want_s))


# ------------------------------------------------------------ train matmul
def _matmul_case(m=16, k=64, n=48, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.05).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


class TestInt8TrainMatmul:
    def test_forward_and_gradients_match_jax(self):
        """Compute dtype f32, as ``tests/test_ops.py`` pins the JAX
        custom_vjp: forward and both gradients to MATMUL_TOL; the port's
        weight is JAX's kernel transposed, and so is its gradient."""
        x, w, cot = _matmul_case()

        def loss(x_, w_):
            return jnp.sum(jax_int8.int8_train_matmul(x_, w_, jnp.float32)
                           * cot)

        want = jax_int8.int8_train_matmul(jnp.asarray(x), jnp.asarray(w),
                                          jnp.float32)
        want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
        y = port_int8.int8_train_matmul(tx, tw, torch.float32)
        dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(cot))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   rtol=MATMUL_TOL, atol=MATMUL_TOL)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                                   rtol=MATMUL_TOL, atol=MATMUL_TOL)
        np.testing.assert_allclose(dw.numpy().T, np.asarray(want_dw),
                                   rtol=MATMUL_TOL, atol=MATMUL_TOL)

    def test_matches_the_ste_oracle(self):
        """The custom backward against autograd through the port's STE
        oracle (``v + (dq(q(v)) - v).detach()``), f32, 1e-5 as the JAX
        package pins its own."""
        x, w, cot = _matmul_case(seed=3)
        outs = []
        for fn in (port_int8.int8_train_matmul,
                   port_int8.reference_int8_train_matmul):
            tx = torch.from_numpy(x).requires_grad_()
            tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
            y = fn(tx, tw, torch.float32)
            outs.append((y.detach(), *torch.autograd.grad(
                y, (tx, tw), torch.from_numpy(cot))))
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def test_f32_gradients_of_bf16_compute_match_jax(self):
        """f32 x and weight, bf16 compute (``param_dtype: float32`` with
        ``dtype: bfloat16``): JAX keeps each backward product's f32 sums
        (``preferred_element_type``), so dx and dw stay f32 and are
        never rounded to bf16. Both packages contract the same bf16
        operands; only the f32 summation order differs (measured 8e-9
        relative L2 for dx, 0 for dw), where the gradients rounded to
        bf16 read 1.7e-3."""
        x, w, cot = _matmul_case(m=32, k=128, n=64, seed=11)

        def loss(x_, w_):
            return jnp.sum(jax_int8.int8_train_matmul(x_, w_, jnp.bfloat16)
                           * cot)

        want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
        y = port_int8.int8_train_matmul(tx, tw, torch.bfloat16)
        dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(cot))
        assert dx.dtype == dw.dtype == torch.float32
        for got, want in ((dx.numpy(), np.asarray(want_dx)),
                          (dw.numpy().T, np.asarray(want_dw))):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-6, rel

    def test_saves_int8_residuals_and_scales_only(self):
        x = torch.randn(20, 24, dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn(8, 24, requires_grad=True)
        y = port_int8.int8_train_matmul(x, w)
        saved = y.grad_fn.saved_tensors
        assert [t.dtype for t in saved] == [torch.int8, torch.float32,
                                            torch.int8, torch.float32]
        assert [tuple(t.shape) for t in saved] == [(20, 24), (20,),
                                                   (8, 24), (8,)]
        assert y.dtype == torch.float32
        dx, dw = torch.autograd.grad(y.sum(), (x, w))
        assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32

    def test_int_product_is_exact(self):
        gen = torch.Generator().manual_seed(0)
        qx = torch.randint(-127, 128, (5, 40), generator=gen,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (3, 40), generator=gen,
                           dtype=torch.int8)
        want = qx.long() @ qw.long().t()
        assert torch.equal(port_int8.int_product(qx, qw), want.float())


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient scaled by ``factor``."""

    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class TestCardSideCheck:
    """``kernel_check.int8_train_check`` on the CPU at a small shape:
    the product as it stands meets ``INT8_TRAIN_TOL``; a weight gradient
    1% off (a uniform scale a cosine cannot see) does not."""

    @pytest.mark.parametrize('wdtype', [torch.bfloat16, torch.float32])
    def test_product_meets_the_bounds(self, wdtype):
        r = kernel_check.int8_train_check(
            (64, 128, 96, wdtype), torch.Generator().manual_seed(0),
            device='cpu')
        assert kernel_check.int8_train_ok(r), r

    def test_mis_scaled_weight_gradient_fails_them(self):
        def faulty(x, w, cd):
            return port_int8.int8_train_matmul(x, _ScaleGrad.apply(w, 1.01),
                                               cd)

        r = kernel_check.int8_train_check(
            (64, 128, 96, torch.bfloat16), torch.Generator().manual_seed(0),
            device='cpu', fn=faulty)
        assert r['y'] <= kernel_check.INT8_TRAIN_TOL['y']
        assert r['dw'] > kernel_check.INT8_TRAIN_TOL['dw']
        assert not kernel_check.int8_train_ok(r)

    def test_shapes_are_the_wide_step_s(self):
        assert kernel_check.INT8_TRAIN_SHAPES[0] == (
            8192, 2048, 3 * 32 * 64, torch.bfloat16)
        assert {s[3] for s in kernel_check.INT8_TRAIN_SHAPES} == {
            torch.bfloat16, torch.float32}


# --------------------------------------------------------------- the model
class TestInt8LM:
    #: the largest row error of the logits. f32 activations: both
    #: packages quantize their own f32 activations, which differ by
    #: summation order (~1e-7), so an x/scale on a rounding edge rounds
    #: the other way now and then, moving one product by a 127th of its
    #: row's absmax (measured ≤ 1e-6). bf16 activations: the packages
    #: round to bf16 at other places (the bf16 LM without int8 differs
    #: by 1.4e-2 of a row), and each bf16 difference near an int8
    #: rounding edge moves a quantized value a whole step, a 127th of the
    #: row's absmax (measured 3.3e-2)
    LOGIT_TOL = {'float32': 1e-4, 'bfloat16': 5e-2}
    #: gradients: f32 to 1e-4 relative L2 a tensor (measured 3e-7); bf16
    #: activations by cosine (measured ≥ 0.99952, the worst at
    #: layers.1.mlp.wi_gate, where int8 steps flipped by bf16 rounding
    #: edges move the gradient by 3% of its norm)
    F32_GRAD_REL = 1e-4
    BF16_GRAD_COSINE = 0.999

    @pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
    def test_logits_and_gradients_match_jax(self, dtype):
        spec = {**LM, 'dtype': dtype}
        tokens = _tokens(2, 16, 256, seed=4)
        params = _jax_params(spec, tokens)
        jmodel = jax_create_model(**spec)

        def loss_fn(p):
            return jax_loop.lm_ce(jmodel.apply({'params': p}, tokens),
                                  tokens)[0]

        jlogits = np.asarray(jmodel.apply({'params': params}, tokens),
                             np.float32)
        jgrads = params_from_jax(jax.tree.map(
            np.asarray, jax.grad(loss_fn)(params)))
        model = _port_model(spec, params)
        assert isinstance(model.layers[0].mlp.wo, Int8DenseGeneral)
        assert type(model.lm_head) is Dense
        logits = model(torch.from_numpy(tokens))
        got = logits.detach().float().numpy()
        err = (np.linalg.norm(got - jlogits, axis=-1)
               / np.linalg.norm(jlogits, axis=-1)).max()
        assert err <= self.LOGIT_TOL[dtype], err
        loss, _ = port_loop.lm_ce(logits, torch.from_numpy(tokens))
        grads = dict(zip((n for n, _ in model.named_parameters()),
                         torch.autograd.grad(loss, list(model.parameters()))))
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            want = jgrads[name].float()
            if dtype == 'float32':
                rel = float((g - want).norm() / want.norm())
                assert rel < self.F32_GRAD_REL, (name, rel)
            else:
                cos = torch.nn.functional.cosine_similarity(
                    g.flatten().float(), want.flatten(), dim=0)
                assert float(cos) >= self.BF16_GRAD_COSINE, name

    def test_state_dict_is_the_same_at_both_precisions(self):
        gen = torch.Generator().manual_seed(0)
        spec = {**LM, 'param_dtype': 'bfloat16'}
        int8 = create_model(**spec, device='cpu', generator=gen)
        bf16 = create_model(**{**spec, 'matmul_precision': 'bf16'},
                            device='cpu')
        a, b = int8.state_dict(), bf16.state_dict()
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                   == torch.bfloat16 for k in a)
        bf16.load_state_dict(a)
        int8.load_state_dict(bf16.state_dict())
        assert jax_kernel_shapes(int8) == jax_kernel_shapes(bf16)

    def test_weight_quantizes_from_the_stored_parameter(self):
        """f32 params, bf16 compute: the weight is quantized from its f32
        values, not from the bf16 copy ``Dense`` would make."""
        layer = Int8DenseGeneral(40, 24, torch.bfloat16, torch.float32)
        torch.nn.init.normal_(layer.weight, std=0.05,
                              generator=torch.Generator().manual_seed(2))
        x = torch.randn(6, 40, dtype=torch.bfloat16)
        want = port_int8.int8_train_matmul(x, layer.weight.detach(),
                                           torch.bfloat16)
        y = layer(x)
        assert y.dtype == torch.bfloat16
        torch.testing.assert_close(y, want.to(torch.bfloat16), rtol=0,
                                   atol=0)
        _, s_f32 = port_int8._quantize_rows(layer.weight.detach())
        _, s_bf16 = port_int8._quantize_rows(
            layer.weight.detach().to(torch.bfloat16))
        assert not torch.equal(s_f32, s_bf16)

    def test_remat_step_gives_the_same_gradients(self):
        """One step with ``remat``: the recompute quantizes the same
        values the forward did (deterministic), so the gradients agree
        to the f32 recompute's own noise."""
        spec = {**LM, 'dtype': 'float32'}
        tokens = torch.from_numpy(_tokens(2, 16, 256, seed=5))
        params = _jax_params(spec, tokens.numpy())
        out = []
        for remat in (False, True):
            model = _port_model({**spec, 'remat': remat}, params)
            loss, _ = port_loop.lm_ce(model(tokens, train=True), tokens)
            out.append((float(loss.detach()), torch.autograd.grad(
                loss, list(model.parameters()))))
        assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
        for a, b in zip(out[0][1], out[1][1]):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- executor
EXEC_SPEC = {
    'model': {'name': 'transformer_lm', 'vocab_size': 64, 'd_model': 32,
              'n_layers': 2, 'n_heads': 2, 'd_ff': 64, 'max_seq_len': 32,
              'dtype': 'float32'},
    'dataset': {'name': 'synthetic_lm', 'n_train': 256, 'n_valid': 64,
                'seq_len': 32, 'vocab_size': 64},
    'loss': {'name': 'lm_ce', 'impl': 'auto', 'z_loss': 1e-4,
             'label_smoothing': 0.1},
    'batch_size': 32, 'main_metric': 'loss', 'minimize': True,
    'stages': [{'name': 's1', 'epochs': 2,
                'optimizer': {'name': 'adamw', 'lr': 3e-3}}],
}


def _int8_spec(spec):
    spec = dict(spec)
    spec['model'] = dict(spec['model'], matmul_precision='int8',
                         param_dtype='bfloat16')
    spec['stages'] = [{'name': 's1', 'epochs': 2,
                       'optimizer': {'name': 'adamw', 'lr': 3e-3,
                                     'master_dtype': 'bfloat16'}}]
    return spec


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_port(tmp_path, spec, name='lm'):
    log = logging.getLogger(f'test_int8_train_{id(tmp_path)}_{name}')
    log.setLevel(logging.INFO)
    lines = _Lines()
    log.addHandler(lines)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        config = {'executors': {'train': {
            'type': 'train', **spec, 'checkpoint_dir': str(tmp_path / name),
            'model_name': name, 'device': 'cpu'}}}
        result = Executor.from_config('train', config)(logger=log)
    finally:
        os.chdir(cwd)
        log.removeHandler(lines)
    return result, lines.lines


class _Step:
    """The DB-less step tracker the JAX trainer reports to."""

    def start(self, *args, **kwargs):
        pass

    def info(self, message):
        pass

    def debug(self, message):
        pass

    def error(self, message):
        pass

    def end_all(self):
        pass


class TestExecutor:
    def test_int8_training_loss_parity(self, tmp_path):
        """The JAX package's ``test_int8_training_loss_parity`` through
        the port's executor, with the fused-CE loss (``impl: auto``, the
        kernels' plain versions on the CPU, z-loss and smoothing): int8
        matmuls with bf16 master weights land within 0.35 of the f32 run's
        best validation loss, and learn (below 4.1; ln 64 = 4.16)."""
        base, _ = _run_port(tmp_path, EXEC_SPEC, 'f32')
        got, lines = _run_port(tmp_path, _int8_spec(EXEC_SPEC), 'int8')
        losses = [ast.literal_eval(line.split(' train ')[1].split(
            ' valid ')[0])['loss'] for line in lines if ' train {' in line]
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert got['best_score'] < 4.1
        assert abs(got['best_score'] - base['best_score']) < 0.35, \
            (got['best_score'], base['best_score'])
        tree, _ = port_ckpt.restore_checkpoint(str(tmp_path / 'int8'))
        kernel = tree['params']['layers']['mlp']['wo']['kernel']
        assert kernel.dtype == torch.bfloat16 and kernel.shape == (2, 64, 32)

    def test_jax_int8_checkpoint_loads_and_trains_in_the_port(self,
                                                                tmp_path):
        """A JAX int8 run's checkpoint (bf16 params in the JAX layout,
        each leaf in a flax ``{'value': ...}`` node): its params load
        into the port's int8 model through ``state_dict_from_jax``, which
        computes JAX's logits from them (f32 activations, LOGIT_TOL) and
        trains on. The optimizer state stays each package's own. The
        per-layer layout keeps JAX's reference apply eager: under
        ``nn.scan`` XLA computes the scale ``absmax / 127`` as ``absmax *
        (1/127)``, one ulp off, and a bf16 weight on a rounding edge of
        ``w / scale`` quantizes a step apart."""
        spec = _int8_spec(EXEC_SPEC)
        spec['model'] = dict(spec['model'], scan_layers=False)
        spec['stages'][0]['epochs'] = 1
        ex = JaxTrain(checkpoint_dir=str(tmp_path / 'jax'),
                      **{**spec, 'loss': 'lm_ce'})
        ex.step, ex.task, ex.session, ex.additional_info = _Step(), None, \
            None, {}
        ex.work()
        tree, meta = port_ckpt.restore_checkpoint(str(tmp_path / 'jax'))
        assert meta['stage'] == 's1'
        model = create_model(**spec['model'], device='cpu')
        model.load_state_dict(state_dict_from_jax(tree, 'transformer_lm'))
        assert model.layers[0].mlp.wo.weight.dtype == torch.bfloat16
        tokens = _tokens(2, 32, 64, seed=6)
        jmodel = jax_create_model(**spec['model'])
        params = jax.tree.map(jnp.asarray, _jax_tree(
            unwrap_value_nodes(tree['params'])))
        want = np.asarray(jmodel.apply({'params': params}, tokens),
                          np.float32)
        got = model(torch.from_numpy(tokens)).detach().float().numpy()
        err = (np.linalg.norm(got - want, axis=-1)
               / np.linalg.norm(want, axis=-1)).max()
        assert err <= TestInt8LM.LOGIT_TOL['float32'], err
        opt, _ = port_optim.make_optimizer(spec['stages'][0]['optimizer'],
                                           10)
        state = port_loop.create_train_state(model, opt)
        step = port_loop.make_train_step(
            model, opt, port_loop.loss_for_task(EXEC_SPEC['loss']),
            self_supervised=True)
        before = model.lm_head.weight.detach().clone()
        state, metrics = step(state, torch.from_numpy(tokens), None)
        assert np.isfinite(float(metrics['loss']))
        assert not torch.equal(model.lm_head.weight, before)

    def test_int8_export_serves_plain_and_quantized(self, tmp_path):
        """The port's int8-trained export (per-layer layout) served plain
        and with ``quantize='int8'``. Plain, both packages run the int8
        training product in the forward (the spec's ``matmul_precision``).
        With ``quantize='int8'`` JAX's interceptor holds seven 2-D kernels
        in its table but reroutes only ``nn.Dense`` modules — the head —
        and the port swaps that one module. Both against JAX's eager
        apply to 1e-5 of a row (f32 activations: summation order). JAX's
        jitted predictor is no reference here: under jit XLA computes the
        scale ``absmax / 127`` as ``absmax * (1/127)``, one ulp off the
        formula, and bf16 weights that land on a rounding edge of
        ``w / scale`` (63.4999…) quantize a step apart."""
        spec = _int8_spec(EXEC_SPEC)
        # kernels of at least 65,536 elements, JAX's quantize threshold
        spec['model'] = dict(spec['model'], scan_layers=False,
                             vocab_size=1024, d_model=64, d_ff=1024)
        spec['dataset'] = dict(spec['dataset'], vocab_size=1024,
                               n_train=64, n_valid=16)
        spec['stages'][0]['epochs'] = 1
        _run_port(tmp_path, spec, 'lm')
        path = str(tmp_path / 'models' / 'lm')
        x = _tokens(3, 32, 1024, seed=8)
        variables, jspec = jax_export.load_export(path)
        assert jspec['matmul_precision'] == 'int8'
        jmodel = jax_create_model(**jspec)
        rerouted = []
        interceptor, table = jax_export._quantized_interceptor(
            variables['params'])

        def spy(next_fun, args, kwargs, context):
            if isinstance(context.module, (nn.Dense, nn.DenseGeneral)) \
                    and context.method_name == '__call__':
                rerouted.append(tuple(context.module.path))
            return interceptor(next_fun, args, kwargs, context)

        with nn.intercept_methods(spy):
            want_q = jmodel.apply(variables, jnp.asarray(x))
        assert table == 7 and rerouted == [('lm_head',)]
        want = {None: jmodel.apply(variables, jnp.asarray(x)),
                'int8': want_q}
        for quantize in (None, 'int8'):
            predict = port_export.make_predictor(
                file=path, batch_size=4, quantize=quantize, device='cpu')
            assert predict.quantized == (len(rerouted) if quantize else 0)
            got = predict(x)
            ref = np.asarray(want[quantize], np.float32)
            err = (np.linalg.norm(got - ref, axis=-1)
                   / np.linalg.norm(ref, axis=-1)).max()
            assert err <= 1e-5, (quantize, err)
            assert isinstance(predict.model.layers[0].mlp.wo,
                              Int8DenseGeneral)


def _jax_tree(tree):
    """A checkpoint tree's leaves as numpy (bf16 torch tensors through
    float32 and back to JAX's bfloat16)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16) \
            if tree.dtype == torch.bfloat16 else tree.numpy()
    return tree


# -------------------------------------------------------------- optimizers
_SHAPES = {'factored': (256, 130), 'wide': (3, 300), 'bias': (7,),
           'cube': (4, 160, 129)}
_STEPS = 3


def _run_both(spec, dtype='float32', kernel_shapes=None, shapes=_SHAPES):
    rng = np.random.RandomState(1)
    init = {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in
              shapes.items()} for _ in range(_STEPS)]
    jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdtype = getattr(torch, dtype)
    jopt, _ = jax_optim.make_optimizer(spec, 100)
    popt, _ = port_optim.make_optimizer(spec, 100,
                                        kernel_shapes=kernel_shapes)
    jparams = {n: jnp.asarray(a, jdtype) for n, a in init.items()}
    pparams = {n: torch.from_numpy(a).to(tdtype) for n, a in init.items()}
    jstate, pstate = jopt.init(jparams), popt.init(pparams)
    out = []
    for g in grads:
        upd, jstate = jopt.update({n: jnp.asarray(a, jdtype)
                                   for n, a in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        upd, pstate = popt.update({n: torch.from_numpy(a).to(tdtype)
                                   for n, a in g.items()}, pstate, pparams)
        port_optim.apply_updates(pparams, upd)
        out.append(({n: np.asarray(jnp.asarray(v, jnp.float32))
                     for n, v in jparams.items()},
                    {n: v.float().numpy().copy()
                     for n, v in pparams.items()}))
    return out, jstate, pstate


class TestLambAndAdafactor:
    @pytest.mark.parametrize('name,extra', [
        ('lamb', {}), ('lamb', {'weight_decay': 0.01, 'grad_clip': 0.5}),
        ('adafactor', {}), ('adafactor', {'grad_clip': 1.0}),
        ('adafactor', {'accum_steps': 2, 'schedule': {
            'name': 'warmup_cosine', 'warmup_steps': 1, 'decay_steps': 4}})])
    def test_matches_optax(self, name, extra):
        """f32: parameters agree with optax's over three steps to 1e-6
        (the same f32 arithmetic in another order); the factored leaves
        (two dims ≥ 128) and the kept-whole ones alike."""
        steps, _, _ = _run_both({'name': name, 'lr': 1e-2, **extra})
        for want, got in steps:
            for n in want:
                np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                           atol=1e-6, err_msg=n)

    @pytest.mark.parametrize('name', ['lamb', 'adafactor'])
    def test_bf16_masters_match_optax(self, name):
        """``master_dtype: bfloat16``: bf16 params, f32 update arithmetic
        on both sides; the params agree within one bf16 rounding."""
        steps, _, pstate = _run_both({'name': name, 'lr': 1e-2,
                                      'master_dtype': 'bfloat16'},
                                     dtype='bfloat16')
        for want, got in steps:
            for n in want:
                np.testing.assert_allclose(got[n], want[n], rtol=2 ** -7,
                                           atol=1e-6, err_msg=n)
        if name == 'adafactor':
            assert pstate['0']['v_row']['factored'].dtype == torch.float32

    def test_adafactor_state_is_optax_s(self):
        """The factored second moments have optax's shapes and values:
        v_row over the largest dim's complement, v_col over the second
        largest's, (1,) placeholders elsewhere."""
        _, jstate, pstate = _run_both({'name': 'adafactor', 'lr': 1e-2})
        jfac, pfac = jstate[0], pstate['0']
        assert pfac['count'] == int(jfac.count) == _STEPS
        for key in ('v_row', 'v_col', 'v'):
            for n in _SHAPES:
                want = np.asarray(getattr(jfac, key)[n])
                got = pfac[key][n].numpy()
                assert got.shape == want.shape, (key, n)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
        assert pfac['v_row']['factored'].shape == (130,)
        assert pfac['v']['wide'].shape == (3, 300)

    def test_adafactor_factors_over_the_jax_kernel_shape(self):
        """A port weight [out, in] whose JAX kernel is a fused [M, 3, H, D]
        factors as optax factors the kernel: here M = 256 and D = 64 are
        the two largest dims, D < 128, so the moments are kept whole,
        where the 2-D port layout [3·H·D, M] would factor."""
        m, h, d = 256, 2, 64
        jshape = (m, 3, h, d)
        rng = np.random.RandomState(3)
        kernel = (rng.randn(*jshape) * 0.1).astype(np.float32)
        grads = [rng.randn(*jshape).astype(np.float32) for _ in range(2)]
        spec = {'name': 'adafactor', 'lr': 1e-2}
        jopt, _ = jax_optim.make_optimizer(spec, 10)
        popt, _ = port_optim.make_optimizer(
            spec, 10, kernel_shapes={'qkv': jshape})
        jp = {'qkv': jnp.asarray(kernel)}
        pp = {'qkv': torch.from_numpy(kernel.reshape(m, -1).T.copy())}
        js, ps = jopt.init(jp), popt.init(pp)
        assert tuple(ps['0']['v']['qkv'].shape) == jshape
        for g in grads:
            upd, js = jopt.update({'qkv': jnp.asarray(g)}, js, jp)
            jp = optax.apply_updates(jp, upd)
            upd, ps = popt.update({'qkv': torch.from_numpy(
                g.reshape(m, -1).T.copy())}, ps, pp)
            port_optim.apply_updates(pp, upd)
        np.testing.assert_allclose(
            pp['qkv'].numpy().T.reshape(jshape), np.asarray(jp['qkv']),
            rtol=1e-6, atol=1e-6)

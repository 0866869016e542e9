"""The port's weight-only int8 serving path against the JAX package's, on
the CPU: ``quantize_int8``, ``int8_matmul``, the fused serving stack,
``make_predictor(quantize='int8')`` with the modules it quantizes, the
server and its CLI, and the chain runner's histogram.

Inputs come from numpy seeds and go through both packages. JAX's Pallas
kernels run in interpret mode, as ``tests/test_ops.py`` runs them; the
port's CUDA wrappers take their plain versions for CPU tensors.
Tolerances are stated where they are used.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import export as jax_export
from mlcomp_tpu_torch import TOKEN
from mlcomp_tpu_torch.convert import port_module_name
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.server.serve import ModelServer
from mlcomp_tpu_torch.telemetry import MetricRecorder
from mlcomp_tpu_torch.testing import (
    kernel_check, kernel_faults, kernel_variants,
)
from mlcomp_tpu_torch.train import export as port_export

# the modules, not the functions of the same name that both ``ops``
# packages export
jax_int8 = importlib.import_module('mlcomp_tpu.ops.int8_matmul')
jax_stack = importlib.import_module('mlcomp_tpu.ops.serving_stack')
port_int8 = importlib.import_module('mlcomp_tpu_torch.ops.int8_matmul')
port_stack = importlib.import_module('mlcomp_tpu_torch.ops.serving_stack')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: f32 products of bf16 and int8 values are exact on both sides; what
#: remains is the f32 summation order over K (~1e-7 relative)
MATMUL_TOL = 1e-5
#: the JAX package's own serving-stack tolerances (tests/test_ops.py):
#: with the feed, and without it, where activations grow
STACK_TOL = 1e-5
STACK_NO_FEED_TOL = 1e-4
#: whole models, f32 both sides, the same int8 weights: the summation
#: order of every product, through a few layers (measured ≤ 2e-6)
MODEL_TOL = 1e-4

LM_SPEC = {'name': 'transformer_lm', 'vocab_size': 1024, 'd_model': 64,
           'n_layers': 2, 'n_heads': 4, 'd_ff': 1024, 'max_seq_len': 8,
           'dtype': 'float32'}
MLP_SPEC = {'name': 'mlp', 'num_classes': 3, 'hidden': [512, 512],
            'dtype': 'float32'}
RESNET_SPEC = {'name': 'resnet18', 'num_classes': 10, 'dtype': 'float32',
               'norm': 'batch', 'num_filters': 8}


def _weights(k, n, seed, zero_col=None):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.05
    if zero_col is not None:
        w[:, zero_col] = 0.0
    return w


# ---------------------------------------------------------------- quantizer
class TestQuantize:
    @pytest.mark.parametrize('k,n,zero_col', [
        (256, 384, None), (256, 384, 7), (100, 99, 0), (1, 5, None),
        (999, 3, 2)])
    def test_bit_identical_to_jax(self, k, n, zero_col):
        w = _weights(k, n, seed=k + n, zero_col=zero_col)
        want_q, want_s = jax_int8.quantize_int8(jnp.asarray(w))
        got_q, got_s = port_int8.quantize_int8(w)
        assert got_q.dtype == torch.int8 and got_q.shape == (n, k)
        assert got_q.is_contiguous()
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                      np.asarray(want_s).view(np.uint32))
        if zero_col is not None:
            assert got_s[zero_col] == 1.0

    def test_halves_round_to_even(self):
        # one column of absmax 127: w / scale is w itself, so ±0.5, 1.5
        # and 2.5 round to 0, 2 and 2 (half to even), as jnp.round does
        w = np.array([[127.0], [0.5], [1.5], [2.5], [-0.5], [-2.5]],
                     np.float32)
        got_q, _ = port_int8.quantize_int8(w)
        want_q, _ = jax_int8.quantize_int8(jnp.asarray(w))
        np.testing.assert_array_equal(got_q.numpy()[0],
                                      [127, 0, 2, 2, 0, -2])
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


# ------------------------------------------------------------------ matmul
class TestInt8Matmul:
    def _case(self, m=32, k=256, n=384, seed=3):
        rng = np.random.RandomState(seed)
        x = rng.randn(m, k).astype(np.float32)
        return x, _weights(k, n, seed + 1)

    @pytest.mark.parametrize('impl', ['auto', 'dense', 'interpret'])
    def test_matches_jax_reference_and_pallas(self, impl):
        x, w = self._case()
        jq, js = jax_int8.quantize_int8(jnp.asarray(w))
        reference = np.asarray(jax_int8.reference_int8_matmul(
            jnp.asarray(x), jq, js))
        pallas = np.asarray(jax_int8.int8_matmul(
            jnp.asarray(x), jq, js, impl='pallas', block_n=128,
            block_k=128, interpret=True))
        q, s = port_int8.quantize_int8(w)
        before = port_int8.int8_matmul.launches
        got = port_int8.int8_matmul(torch.from_numpy(x), q, s, impl=impl)
        assert port_int8.int8_matmul.launches == before   # plain version
        assert got.dtype == torch.float32 and got.shape == (32, 384)
        np.testing.assert_allclose(got.numpy(), reference, rtol=MATMUL_TOL,
                                   atol=MATMUL_TOL)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=MATMUL_TOL,
                                   atol=MATMUL_TOL)

    def test_ragged_shape_matches_jax(self):
        # the TPU path's tile gate (M%8, K%128, N%128) does not apply
        x, w = self._case(m=5, k=100, n=99, seed=8)
        jq, js = jax_int8.quantize_int8(jnp.asarray(w))
        want = np.asarray(jax_int8.int8_matmul(jnp.asarray(x), jq, js))
        q, s = port_int8.quantize_int8(w)
        got = port_int8.int8_matmul(torch.from_numpy(x), q, s)
        np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_TOL,
                                   atol=MATMUL_TOL)

    def test_x_rounds_to_bf16_first(self):
        # an f32 x is cast to bf16 before the product, as in JAX
        x, w = self._case(m=4, k=64, n=8, seed=5)
        q, s = port_int8.quantize_int8(w)
        xt = torch.from_numpy(x)
        got = port_int8.int8_matmul(xt, q, s)
        bf = port_int8.int8_matmul(xt.to(torch.bfloat16), q, s)
        torch.testing.assert_close(got, bf, rtol=0, atol=0)
        exact = (xt.double() @ q.double().t()) * s.double()
        assert not torch.equal(got.double(), exact)

    def test_errors(self):
        x, w = self._case(m=4, k=64, n=8)
        q, s = port_int8.quantize_int8(w)
        xt = torch.from_numpy(x)
        with pytest.raises(ValueError, match='shape mismatch'):
            port_int8.int8_matmul(xt, q, s[:-1])
        with pytest.raises(ValueError, match='shape mismatch'):
            port_int8.int8_matmul(xt[:, :-1], q, s)
        with pytest.raises(ValueError, match='unknown impl'):
            port_int8.int8_matmul(xt, q, s, impl='triton')
        for impl in ('cuda', 'pallas'):
            with pytest.raises(ValueError, match="'cuda' needs CUDA"):
                port_int8.int8_matmul(xt, q, s, impl=impl)
        with pytest.raises(ValueError, match='out='):
            port_int8.int8_matmul(xt, q, s, out=torch.empty(4, 8))

    @pytest.mark.parametrize('with_bias', [True, False])
    @pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16,
                                       torch.float32])
    def test_fused_epilogue_matches_jax_interceptor(self, with_bias, dtype):
        # _quantized_interceptor: int8_matmul, + bias in f32, astype. The
        # products agree to the f32 summation order (MATMUL_TOL); the
        # epilogue itself, fed JAX's own f32 product, bit for bit
        x, w = self._case(m=24, k=256, n=136, seed=11)
        bias = np.random.RandomState(12).randn(136).astype(np.float32)
        jq, js = jax_int8.quantize_int8(jnp.asarray(w))
        jy = jax_int8.int8_matmul(jnp.asarray(x), jq, js)
        if with_bias:
            jy = jy + jnp.asarray(bias, jnp.float32)
        jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
                  torch.float32: jnp.float32}[dtype]
        want = np.asarray(jy.astype(jdtype).astype(jnp.float32))
        q, s = port_int8.quantize_int8(w)
        tb = torch.from_numpy(bias) if with_bias else None
        got = port_int8.int8_matmul(torch.from_numpy(x), q, s, bias=tb,
                                    out_dtype=dtype)
        assert got.dtype == dtype and got.shape == (24, 136)
        ulp = {torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11,
               torch.float32: MATMUL_TOL}[dtype]
        np.testing.assert_allclose(got.float().numpy(), want, rtol=ulp,
                                   atol=ulp)
        y = torch.from_numpy(np.asarray(
            jax_int8.int8_matmul(jnp.asarray(x), jq, js)))
        epi = port_int8.reference_epilogue(y, tb, dtype)
        np.testing.assert_array_equal(epi.float().numpy(), want)

    def test_bad_epilogue_arguments_raise(self):
        x, w = self._case(m=4, k=64, n=8)
        q, s = port_int8.quantize_int8(w)
        xt = torch.from_numpy(x)
        with pytest.raises(ValueError, match='out_dtype'):
            port_int8.int8_matmul(xt, q, s, out_dtype=torch.int32)
        with pytest.raises(ValueError, match='bias'):
            port_int8.int8_matmul(xt, q, s, bias=torch.zeros(7))
        with pytest.raises(ValueError, match='bias'):
            port_int8.int8_matmul(xt, q, s, bias=torch.zeros(8, 1))

    def test_tma_operand_pads_k_with_zeros(self):
        # the kernel's operands: K zero-padded to a multiple of 16
        t = torch.arange(15, dtype=torch.int8).reshape(3, 5)
        got = port_int8.tma_operand(t, 16)
        assert got.shape == (3, 16) and got.is_contiguous()
        assert torch.equal(got[:, :5], t) and not got[:, 5:].any()
        same = torch.zeros((4, 32), dtype=torch.bfloat16)
        assert port_int8.tma_operand(same, 32) is same


class TestInt8Dense:
    @pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32, None])
    def test_bias_in_f32_then_module_dtype(self, dtype):
        rng = np.random.RandomState(0)
        w = torch.from_numpy(rng.randn(3, 5, 300).astype(np.float32))
        q, s = port_int8.quantize_int8(rng.randn(300, 20).astype(
            np.float32))
        bias = torch.from_numpy(rng.randn(20).astype(np.float32))
        layer = port_int8.Int8Dense(q, s, bias, dtype)
        y = layer(w)
        want = port_int8.reference_int8_matmul(w.reshape(-1, 300), q, s) \
            + bias
        want = want.reshape(3, 5, 20).to(dtype or torch.float32)
        assert y.dtype == (dtype or torch.float32)
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        assert {n for n, _ in layer.named_buffers()} == {
            'w_qt', 'scale', 'bias'}

    def test_dtype_outside_the_kernels_outputs_casts_after(self):
        # f64 is not one of the kernel's output types: the f32 product
        # with the bias, then the cast, as JAX's astype
        rng = np.random.RandomState(1)
        x = torch.from_numpy(rng.randn(6, 64).astype(np.float32))
        q, s = port_int8.quantize_int8(rng.randn(64, 9).astype(np.float32))
        bias = torch.from_numpy(rng.randn(9).astype(np.float32))
        y = port_int8.Int8Dense(q, s, bias, torch.float64)(x)
        want = (port_int8.reference_int8_matmul(x, q, s) + bias).double()
        assert y.dtype == torch.float64
        torch.testing.assert_close(y, want, rtol=0, atol=0)


# ----------------------------------------------------------- serving stack
class TestServingStack:
    def _mats(self, layers=3, kn=256, m=16, seed=0):
        rng = np.random.RandomState(seed)
        ws = [rng.randn(kn, kn).astype(np.float32) * 0.05
              for _ in range(layers)]
        x = rng.randn(m, kn).astype(np.float32)
        return x, ws

    @staticmethod
    def _bf16(x):
        """x rounded to bf16, as numpy f32 (both packages get it)."""
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    def test_int8_stack_matches_jax(self):
        x, ws = self._mats()
        x = self._bf16(x)
        jq, js = jax_stack.quantize_stack([jnp.asarray(w) for w in ws])
        want = np.asarray(jax_stack.serving_stack(
            jnp.asarray(x, jnp.bfloat16), jq, js, block_n=128, block_k=128,
            interpret=True))
        q, s = port_stack.quantize_stack(ws)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        got = port_stack.serving_stack(torch.from_numpy(x), q, s,
                                       block_n=128, block_k=128)
        np.testing.assert_allclose(got.numpy(), want, rtol=STACK_TOL,
                                   atol=STACK_TOL)
        ref = port_stack.reference_stack(torch.from_numpy(x), q, s)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)

    @pytest.mark.parametrize('feed,tol', [(True, STACK_TOL),
                                          (False, STACK_NO_FEED_TOL)])
    def test_bf16_stack_matches_jax(self, feed, tol):
        x, ws = self._mats(seed=3 if feed else 5)
        x = self._bf16(x)
        wb = [self._bf16(w) for w in ws]
        jw = jnp.stack([jnp.asarray(w, jnp.bfloat16) for w in wb])
        want = np.asarray(jax_stack.serving_stack(
            jnp.asarray(x, jnp.bfloat16), jw, feed=feed, block_n=128,
            block_k=128, interpret=True))
        pw = torch.stack([torch.from_numpy(w).to(torch.bfloat16)
                          for w in wb])
        got = port_stack.serving_stack(torch.from_numpy(x), pw, feed=feed,
                                       block_n=128, block_k=128)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)

    def test_feed_matches_jax(self):
        y = np.random.RandomState(4).randn(16, 256).astype(np.float32) * 3
        want = np.asarray(jax_stack.stack_feed(jnp.asarray(y)))
        got = port_stack.stack_feed(torch.from_numpy(y))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
        assert port_stack.FEED_EPS == jax_stack.FEED_EPS

    def test_errors(self):
        x = torch.zeros((8, 256), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match='square layers'):
            port_stack.serving_stack(x, torch.zeros((2, 128, 256),
                                                    dtype=torch.int8))
        with pytest.raises(ValueError, match='tile'):
            port_stack.serving_stack(x, torch.zeros((2, 256, 256),
                                                    dtype=torch.int8),
                                     block_n=100)
        with pytest.raises(ValueError, match='scales'):
            port_stack.serving_stack(x, torch.zeros((2, 256, 256),
                                                    dtype=torch.int8),
                                     torch.ones(2, 128), block_n=128,
                                     block_k=128)

    def test_interpret_is_the_plain_version(self):
        # JAX's interpret flag reads as 'auto', as in every wrapper of the
        # port: the plain version for a CPU tensor, and no plain version
        # for a tensor elsewhere (here 'meta', which the kernel refuses
        # as it would run a CUDA tensor through the kernel)
        x, ws = self._mats(layers=2, kn=128, m=4, seed=7)
        q, s = port_stack.quantize_stack(ws)
        xt = torch.from_numpy(x)
        got = port_stack.serving_stack(xt, q, s, block_n=128, block_k=128,
                                       interpret=True)
        torch.testing.assert_close(
            got, port_stack.reference_stack(xt, q, s), rtol=0, atol=0)
        with pytest.raises(ValueError, match='runs on cuda'):
            port_stack.serving_stack(xt.to('meta'), q.to('meta'),
                                     s.to('meta'), block_n=128,
                                     block_k=128, interpret=True)
        wq, ws0 = port_int8.quantize_int8(ws[0])
        with pytest.raises(ValueError, match='runs on cuda'):
            port_int8.int8_matmul(xt.to('meta'), wq.to('meta'),
                                  ws0.to('meta'), impl='interpret')

    def test_chain_runner_feeds_its_recorder(self):
        x, ws = self._mats(layers=2, kn=128, m=4, seed=6)
        q, s = port_stack.quantize_stack(ws)
        rec = MetricRecorder(component='serving')
        run = port_stack.make_chain_runner(
            lambda x, q, s: port_stack.stack_feed(port_stack.serving_stack(
                x, q, s, block_n=128, block_k=128)),
            [q, s], torch.from_numpy(x).to(torch.bfloat16), reps=3,
            recorder=rec, metric='serving.int8_stack_ms')
        first = run()
        assert run() == first and run() == first     # deterministic
        summary = rec.histogram_summaries()['serving.int8_stack_ms']
        assert summary['count'] == 2.0               # the first is warm-up
        assert 0 < summary['min'] <= summary['p50'] <= summary['max']
        assert set(summary) == {'count', 'mean', 'min', 'max', 'p50',
                                'p95', 'p99'}


# ---------------------------------------------------------------- predictor
def _jax_model_export(folder, spec, x, seed=0, meta=None):
    variables = jax_create_model(**spec).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    return jax_export.export_model(
        os.path.join(str(folder), spec['name']), variables['params'], spec,
        batch_stats=variables.get('batch_stats'), meta=meta)


def _jax_count(path):
    variables, _ = jax_export.load_export(path)
    return jax_export._quantized_interceptor(variables['params'])[1]


def _row_error(got, want):
    """max over rows (all leading dims) of |got - want| / |want|, the
    norms along the last axis."""
    got = got.reshape(-1, got.shape[-1]).astype(np.float64)
    want = want.reshape(-1, want.shape[-1]).astype(np.float64)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


def _jax_module_io(path, x):
    """{JAX module path: (input, output)} of every module JAX's
    ``_quantized_interceptor`` reroutes, from one eager quantized apply
    of the export at ``path``."""
    import flax.linen as nn
    variables, spec = jax_export.load_export(path)
    interceptor, _ = jax_export._quantized_interceptor(variables['params'])
    names = set(port_export.quantized_modules(variables['params']))
    seen = {}

    def spy(next_fun, args, kwargs, context):
        y = interceptor(next_fun, args, kwargs, context)
        path = tuple(context.module.path)
        if context.method_name == '__call__' and path and \
                port_module_name(path) in names:
            seen[path] = (np.asarray(args[0]), np.asarray(y))
        return y

    with nn.intercept_methods(spy):
        jax_create_model(**spec).apply(variables, jnp.asarray(x),
                                       train=False)
    return seen


class TestPredictor:
    #: the LM end to end: each package casts its own f32 activations to
    #: bf16 before an int8 product, and where they differ by their f32
    #: summation order (~1e-6) a value on a bf16 rounding edge rounds the
    #: other way, moving one product by 2^-8 of itself (measured row
    #: errors 5e-4 stacked, 1.5e-3 per layer; quantizing moves the rows
    #: by 5.6e-3 and 1.5e-2). Each module alone is held to MATMUL_TOL
    LM_ROW_TOL = 3e-3

    @pytest.mark.parametrize('case,want_n', [
        ('mlp', 1), ('lm_stacked', 1), ('lm_per_layer', 7),
        ('resnet18', 0)])
    def test_matches_jax_and_swaps_what_jax_quantizes(self, tmp_path, case,
                                                      want_n):
        rng = np.random.RandomState(11)
        if case == 'mlp':
            spec, x = MLP_SPEC, rng.rand(6, 8, 8, 1).astype(np.float32)
        elif case == 'resnet18':
            spec = RESNET_SPEC
            x = (rng.randn(3, 8, 8, 3) + 0.5).astype(np.float32)
        else:
            spec = {**LM_SPEC, 'scan_layers': case == 'lm_stacked'}
            x = rng.randint(0, 1024, (3, 8)).astype(np.int32)
        path = _jax_model_export(tmp_path, spec, x[:1])
        assert _jax_count(path) == want_n
        want = jax_export.make_predictor(file=path, batch_size=4,
                                         quantize='int8')(x)
        plain = port_export.make_predictor(file=path, batch_size=4,
                                           device='cpu')
        predict = port_export.make_predictor(file=path, batch_size=4,
                                             quantize='int8', device='cpu')
        assert predict.quantized == want_n
        swapped = [n for n, m in predict.model.named_modules()
                   if isinstance(m, port_int8.Int8Dense)]
        assert len(swapped) == want_n
        got = predict(x)
        assert got.shape == want.shape
        if case.startswith('lm'):
            assert _row_error(got, want) <= self.LM_ROW_TOL
        else:
            np.testing.assert_allclose(got, want, rtol=MODEL_TOL,
                                       atol=MODEL_TOL)
        if want_n:
            assert not np.array_equal(got, plain(x))
        else:
            np.testing.assert_array_equal(got, plain(x))

        # each swapped module on the very input JAX's rerouted module saw
        seen = _jax_module_io(path, x)
        assert len(seen) == want_n
        for jax_path, (x_in, y_jax) in seen.items():
            module = predict.model.get_submodule(port_module_name(jax_path))
            with torch.no_grad():
                y = module(torch.from_numpy(np.array(x_in))).numpy()
            assert y.dtype == y_jax.dtype
            np.testing.assert_allclose(y, y_jax, rtol=MATMUL_TOL,
                                       atol=MATMUL_TOL)

    def test_modules_follow_the_jax_tree(self, tmp_path):
        x = np.zeros((1, 8), np.int32)
        stacked = _jax_model_export(tmp_path / 's', {
            **LM_SPEC, 'scan_layers': True}, x)
        per_layer = _jax_model_export(tmp_path / 'p', {
            **LM_SPEC, 'scan_layers': False}, x)
        assert port_export.quantized_modules(
            jax_export.load_export(stacked)[0]['params']) == ['lm_head']
        assert sorted(port_export.quantized_modules(
            jax_export.load_export(per_layer)[0]['params'])) == sorted(
            [f'layers.{i}.mlp.{p}' for i in range(2)
             for p in ('wi_gate', 'wi_up', 'wo')] + ['lm_head'])

    @pytest.mark.parametrize('path,name', [
        (('layer_3', 'mlp', 'wo'), 'layers.3.mlp.wo'),
        (('lm_head',), 'lm_head'), (('dense_0',), 'dense_0'),
        (('head',), 'head')])
    def test_port_module_name(self, path, name):
        assert port_module_name(path) == name

    def test_f32_weights_are_not_kept(self, tmp_path):
        x = np.zeros((1, 8), np.int32)
        path = _jax_model_export(tmp_path, {**LM_SPEC, 'scan_layers': False},
                                 x)
        model = port_export.make_predictor(file=path, quantize='int8',
                                           device='cpu').model
        names = {n for n, _ in model.named_parameters()}
        assert 'lm_head.weight' not in names
        assert 'layers.0.mlp.wo.weight' not in names
        assert 'layers.0.attn.qkv.weight' in names
        head = model.lm_head
        assert head.w_qt.dtype == torch.int8 and head.w_qt.shape == (
            1024, 64)
        assert head.bias is None and head.dtype == torch.float32

    def test_bad_quantize_raises(self, tmp_path):
        path = _jax_model_export(tmp_path, MLP_SPEC,
                                 np.zeros((1, 8, 8, 1), np.float32))
        with pytest.raises(ValueError, match="'int8'"):
            port_export.make_predictor(file=path, quantize='int4',
                                       device='cpu')


# ------------------------------------------------------------------ server
def _post(port, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/predict', data=json.dumps(body).encode(),
        headers={'Authorization': TOKEN})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class TestServe:
    def test_model_server_answers_predict(self, tmp_path):
        """The int8 endpoint of tests/test_serve.py's TestQuantizedServing,
        against JAX's quantized predictor."""
        x0 = np.zeros((1, 8, 8, 1), np.float32)
        path = _jax_model_export(tmp_path, MLP_SPEC, x0,
                                 meta={'input_shape': [8, 8, 1]})
        srv = ModelServer(path, batch_size=8, activation='softmax', port=0,
                          quantize='int8', device='cpu')
        assert srv.warmup() is True
        srv.bind()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            x = np.random.RandomState(3).rand(4, 8, 8, 1).astype(np.float32)
            out = np.asarray(_post(srv.port, {'x': x.tolist()})['y'])
        finally:
            srv.shutdown()
        want = jax_export.make_predictor(file=path, batch_size=8,
                                         activation='softmax',
                                         quantize='int8')(x)
        np.testing.assert_allclose(out, want, rtol=MODEL_TOL, atol=MODEL_TOL)
        assert srv.primary.predict.quantized == 1

    def test_cli_serves_int8(self, tmp_path):
        """``python -m mlcomp_tpu_torch.server serve ... --quantize int8``
        in a subprocess: one request, then SIGTERM drains."""
        x = np.zeros((1, 8), np.int32)
        spec = {**LM_SPEC, 'scan_layers': True}
        path = _jax_model_export(tmp_path, spec, x,
                                 meta={'input_shape': [8],
                                       'input_dtype': 'int32'})
        tokens = np.random.RandomState(5).randint(0, 1024, (2, 8))
        want = jax_export.make_predictor(file=path, batch_size=2,
                                         activation='argmax',
                                         quantize='int8')(tokens)
        proc = subprocess.Popen(
            [sys.executable, '-m', 'mlcomp_tpu_torch.server', 'serve', path,
             '--device', 'cpu', '--port', '0', '--batch-size', '2',
             '--activation', 'argmax', '--quantize', 'int8'],
            cwd=REPO, env={**os.environ, 'PYTHONPATH': REPO},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert 'quantize=int8' in line, line + proc.stderr.read()
            port = int(line.split('http://127.0.0.1:')[1].split()[0])
            y = np.asarray(_post(port, {'x': tokens.tolist()})['y'])
            np.testing.assert_array_equal(y, want)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def test_cli_refuses_other_quantize(self, capsys):
        from mlcomp_tpu_torch.server.__main__ import main
        with pytest.raises(SystemExit) as e:
            main(['serve', 'm', '--device', 'cpu', '--quantize', 'int4'])
        assert e.value.code == 2
        assert 'int8' in capsys.readouterr().err


# ------------------------------------------------------- the card's checks
class TestCardChecks:
    """What the card-side checks of the two kernels rest on, on the CPU:
    the planted faults edit the shipped sources, the sources name what
    they replace, and the check shapes are the main path's."""

    @pytest.mark.parametrize('kernel,fault', [
        (kernel_faults.INT8_KERNEL, f) for f in kernel_faults.INT8_FAULTS] + [
        (kernel_faults.STACK_KERNEL, f) for f in kernel_faults.STACK_FAULTS])
    def test_planted_fault_edits_the_shipped_source_once(self, kernel, fault):
        faults = {kernel_faults.INT8_KERNEL: kernel_faults.INT8_FAULTS,
                  kernel_faults.STACK_KERNEL: kernel_faults.STACK_FAULTS}
        for edit in faults[kernel][fault]:
            file, old, new = edit if len(edit) == 3 else (
                kernel + '.cu', *edit)
            with open(os.path.join(_build.CSRC_DIR, file)) as fh:
                assert fh.read().count(old) == 1 and new != old

    @pytest.mark.parametrize('name,replaces', [
        ('int8_matmul', ('`_kernel`', 'mlcomp_tpu/ops/int8_matmul.py')),
        ('serving_stack', ('`_stack_kernel`',
                           'mlcomp_tpu/ops/serving_stack.py'))])
    def test_kernel_source_names_what_it_replaces(self, name, replaces):
        with open(os.path.join(_build.CSRC_DIR, name + '.cu')) as fh:
            head = fh.read(4000)
        for text in replaces + ('sm_90a', '3.35 TB/s'):
            assert text in head
        assert name in _build.kernel_names()

    def test_check_shapes_hold_the_main_path(self):
        # the served flagship at batch 4: M = 4·8192 through d_model 1024,
        # d_ff 4096 and the 32768-token vocabulary; the bench's stack
        assert {(32768, 1024, 4096), (32768, 4096, 1024),
                (32768, 1024, 32768), (64, 8192, 8192)} <= set(
            kernel_check.INT8_SHAPES)
        assert kernel_check.STACK_SHAPES[0] == (8, 64, 8192, torch.int8,
                                                True)
        assert kernel_check.stack_tol(1) == kernel_check.STACK_ROW_TOL['step']

    def test_epilogue_check_on_the_cpu(self):
        # the plain version is the unfused formula: no element differs
        gen = torch.Generator().manual_seed(0)
        r = kernel_check.int8_epilogue_check((5, 48, 11), gen, 'cpu')
        assert set(r) == {'bias_bfloat16', 'none_bfloat16', 'bias_float16'}
        assert kernel_check.int8_epilogue_ok(r)
        assert not kernel_check.int8_epilogue_ok({**r, 'none_bfloat16': 1})

    def test_check_shapes_cross_the_tiles_edges(self):
        shapes = kernel_check.INT8_SHAPES
        # past the small configuration (64 tokens) and the large one's
        # 128 and 256; N off the channel tiles and the 4-column stores;
        # K padded for TMA; K = 8192 at large M
        assert {65, 129, 257} <= {m for m, _, _ in shapes}
        assert any(n % 4 for _, _, n in shapes)
        assert any(n % 128 for m, _, n in shapes if m > 64)
        assert any(k % 16 for m, k, _ in shapes if m > 64)
        assert any(k == 8192 for m, k, _ in shapes if m > 64)
        assert (32768, 1024, 4096) in kernel_check.INT8_EPILOGUE_SHAPES
        # a width the cluster's 8-way K split does not divide, two token
        # tiles, two resident pieces
        stack = kernel_check.STACK_SHAPES
        assert any(k % (8 * 128) for _, _, k, _, _ in stack)
        assert any(m > 64 for _, m, _, _, _ in stack)
        assert any(k > 8 * 1024 for _, _, k, _, _ in stack)
        # every fault runs against the epilogue too
        assert kernel_faults.INT8_CHECKS[-len(
            kernel_check.INT8_EPILOGUE_SHAPES):] == [
            ('epilogue', sh) for sh in kernel_check.INT8_EPILOGUE_SHAPES]

    def test_faults_cover_the_new_design(self):
        assert len(kernel_faults.INT8_FAULTS) >= 6
        assert len(kernel_faults.STACK_FAULTS) >= 4
        assert {'stage_index_off_by_one', 'weight_fragment_k_pair_swapped',
                'bias_by_contracted_fma', 'unmasked_n_tail_store',
                'split_sum_drops_last_split'} <= set(
            kernel_faults.INT8_FAULTS)
        assert {'cluster_partial_dropped', 'cluster_partial_of_own_rank',
                'feed_max_of_own_block'} <= set(kernel_faults.STACK_FAULTS)

    @pytest.mark.parametrize('kernel,variant', [
        (kernel_faults.INT8_KERNEL, v)
        for v in sorted(kernel_variants.INT8_VARIANTS)] + [
        (kernel_faults.STACK_KERNEL, v)
        for v in sorted(kernel_variants.STACK_VARIANTS)])
    def test_variant_edits_the_shipped_source_once(self, kernel, variant):
        table = {kernel_faults.INT8_KERNEL: kernel_variants.INT8_VARIANTS,
                 kernel_faults.STACK_KERNEL: kernel_variants.STACK_VARIANTS}
        with open(os.path.join(_build.CSRC_DIR, kernel + '.cu')) as fh:
            source = fh.read()
        for old, new in table[kernel][variant][1]:
            assert source.count(old) == 1 and new != old

    @pytest.mark.parametrize('name,kernel', [
        ('int8_matmul', 'int8_wgmma_kernel'),
        ('serving_stack', 'stack_wgmma_kernel')])
    def test_products_are_wgmma_with_tma(self, name, kernel):
        # no mma.sync product and no cp.async ring is left in the two
        # sources or their header; the smoke fails where an instantiation
        # lacks HGMMA in its SASS
        texts = []
        for f in (name + '.cu', 'int8_gemm.cuh'):
            with open(os.path.join(_build.CSRC_DIR, f)) as fh:
                texts.append(fh.read())
        both = '\n'.join(texts)
        for gone in ('Mma<', 'cp_async', 'ldmatrix'):
            assert gone not in both
        for used in ('Wgmma<bf16', 'tma_load_', 'mbar_wait', kernel):
            assert used in both
        with open(os.path.join(os.path.dirname(_build.PACKAGE_DIR),
                               'chip_smoke.py')) as fh:
            assert f"'{name}': ('{name}', '{kernel}')" in fh.read()

    def test_inputs_on_the_cpu(self):
        gen = torch.Generator().manual_seed(0)
        x, w_qt, scale = kernel_check.int8_inputs(3, 40, 7, gen, 'cpu')
        assert x.dtype == torch.bfloat16 and w_qt.shape == (7, 40)
        x, w, s = kernel_check.stack_inputs(2, 3, 16, torch.bfloat16, gen,
                                            'cpu')
        assert w.shape == (2, 16, 16) and w.dtype == torch.bfloat16
        assert s is None

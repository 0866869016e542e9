"""The port's blocked softmax cross-entropy against the JAX package's, on
the CPU: the plain versions of the two CE kernels (what a CPU tensor
runs) against ``softmax_ce_per_example(impl='pallas', interpret=True)``
at tileable shapes and against ``impl='dense'`` at shapes the TPU kernel
cannot tile, ``lm_ce_with`` through a 2-layer LM, the ``impl`` rule, and
what the card-side checks of ``csrc/fused_ce.cu`` rest on.

Inputs come from numpy seeds and go through both packages; tolerances
are stated where they are used.
"""

import importlib
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu_torch.convert import params_from_jax
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.testing import kernel_check, kernel_faults
from mlcomp_tpu_torch.train import loop as port_loop

jax_ce = importlib.import_module('mlcomp_tpu.ops.fused_ce')
port_ce = importlib.import_module('mlcomp_tpu_torch.ops.fused_ce')

#: f32 on both sides, the same formula: summation order over V ≤ 512
#: (and XLA's exp against torch's) — measured ≤ 5e-7
F32_TOL = 1e-5
#: bf16 logits, f32 arithmetic: the gradient's one rounding to bf16
#: (2^-9 relative) where the two sides' f32 values straddle a rounding
#: edge
BF16_TOL = 2 ** -8
PAIRS = [(0.0, 0.0), (1e-4, 0.0), (0.0, 0.1), (1e-4, 0.1)]


def _case(n, v, seed=0, lo=0, hi=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, v) * 2.0).astype(dtype)
    labels = rng.randint(lo, v if hi is None else hi, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    return logits, labels, g


def _jax_value_and_dx(logits, labels, g, **kw):
    """JAX's per-example losses and the logits' gradient under the
    cotangent g."""
    loss, vjp = jax.vjp(lambda x: jax_ce.softmax_ce_per_example(
        x, jnp.asarray(labels), **kw), jnp.asarray(logits))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(g))[0])


def _port_value_and_dx(logits, labels, g, **kw):
    x = torch.from_numpy(np.array(logits, np.float32)).requires_grad_()
    loss = port_ce.softmax_ce_per_example(x, torch.from_numpy(labels), **kw)
    dx, = torch.autograd.grad(loss, x, torch.from_numpy(g))
    return loss.detach().numpy(), dx


class TestKernelPlainVersions:
    @pytest.mark.parametrize('z_loss,smoothing', PAIRS)
    def test_forward_and_backward_match_the_interpreted_kernel(
            self, z_loss, smoothing):
        """Loss, lse and dx of the plain versions against the Pallas
        kernels in interpret mode (N % 8, V % 128: tileable), f32, to
        F32_TOL."""
        logits, labels, g = _case(64, 512, seed=1)
        kw = dict(z_loss=z_loss, label_smoothing=smoothing)
        want_loss, want_dx = _jax_value_and_dx(
            logits, labels, g, impl='pallas', interpret=True, **kw)
        _, want_lse = jax_ce._pallas_ce_fwd(
            jnp.asarray(logits), jnp.asarray(labels), 8, 128, True,
            z_loss, smoothing)
        x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
        loss, lse = port_ce.reference_ce_fwd(x, y, **kw)
        dx = port_ce.reference_ce_bwd(x, y, lse, torch.from_numpy(g), **kw)
        np.testing.assert_allclose(loss.numpy(), want_loss, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=F32_TOL,
                                   atol=F32_TOL)
        # the entry point (``auto`` on a CPU tensor: FusedCE over the
        # plain versions) gives the same numbers
        got_loss, got_dx = _port_value_and_dx(logits, labels, g,
                                              impl='auto', **kw)
        np.testing.assert_allclose(got_loss, want_loss, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=F32_TOL,
                                   atol=F32_TOL)

    def test_bf16_gradients_stay_bf16(self):
        """bf16 logits give a bf16 gradient, as the TPU kernel writes it
        (``tests/test_ops.py``), within BF16_TOL of JAX's."""
        logits, labels, g = _case(16, 256, seed=2)
        want_loss, want_dx = _jax_value_and_dx(
            jnp.asarray(logits, jnp.bfloat16), labels, g, impl='pallas',
            interpret=True, z_loss=1e-4, label_smoothing=0.1)
        assert want_dx.dtype == jnp.bfloat16
        x = torch.from_numpy(np.array(jnp.asarray(
            logits, jnp.bfloat16).astype(jnp.float32))).to(torch.bfloat16)
        x.requires_grad_()
        loss = port_ce.softmax_ce_per_example(
            x, torch.from_numpy(labels), z_loss=1e-4, label_smoothing=0.1)
        dx, = torch.autograd.grad(loss, x, torch.from_numpy(g))
        assert dx.dtype == torch.bfloat16
        np.testing.assert_allclose(loss.detach().numpy(), want_loss,
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(dx.float().numpy(),
                                   np.asarray(want_dx, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL * 1e-2)

    def test_out_of_range_labels_clamp(self):
        """Labels below 0 and at or past V read as 0 and V - 1 on both
        sides, in the loss and its gradient."""
        logits, labels, g = _case(32, 256, seed=3, lo=-20, hi=300)
        assert (labels < 0).any() and (labels >= 256).any()
        kw = dict(z_loss=1e-4, label_smoothing=0.1)
        want_loss, want_dx = _jax_value_and_dx(
            logits, labels, g, impl='pallas', interpret=True, **kw)
        got_loss, got_dx = _port_value_and_dx(logits, labels, g, **kw)
        clamped = np.clip(labels, 0, 255)
        same_loss, same_dx = _port_value_and_dx(logits, clamped, g, **kw)
        np.testing.assert_allclose(got_loss, want_loss, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(got_loss, same_loss)
        torch.testing.assert_close(got_dx, same_dx, rtol=0, atol=0)

    @pytest.mark.parametrize('n,v', [(7, 300), (1, 127), (5, 1),
                                     (13, 1001)])
    def test_untileable_shapes_match_jax_dense(self, n, v):
        """Shapes the TPU kernel refuses (N % 8 or V % 128): the port's
        kernel path takes them; its plain versions against JAX's dense
        formulation, to F32_TOL."""
        logits, labels, g = _case(n, v, seed=n + v)
        with pytest.raises(ValueError, match='does not tile'):
            jax_ce.softmax_ce_per_example(
                jnp.asarray(logits), jnp.asarray(labels), impl='pallas',
                interpret=True)
        for z_loss, smoothing in PAIRS:
            kw = dict(z_loss=z_loss, label_smoothing=smoothing)
            want_loss, want_dx = _jax_value_and_dx(logits, labels, g,
                                                   impl='dense', **kw)
            got_loss, got_dx = _port_value_and_dx(logits, labels, g,
                                                  impl='auto', **kw)
            np.testing.assert_allclose(got_loss, want_loss, rtol=F32_TOL,
                                       atol=F32_TOL)
            np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=F32_TOL,
                                       atol=F32_TOL)

    def test_autograd_function_saves_logits_labels_and_lse(self):
        x = torch.randn(6, 40, requires_grad=True)
        loss = port_ce.softmax_ce_per_example(x, torch.arange(6),
                                              z_loss=1e-4)
        saved = loss.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [(6, 40), (6,), (6,)]
        assert saved[0] is x or saved[0].data_ptr() == x.data_ptr()
        assert saved[2].dtype == torch.float32

    def test_plain_versions_launch_nothing(self):
        before = (port_ce.ce_forward.launches, port_ce.ce_backward.launches,
                  port_ce.softmax_ce_per_example.launches)
        x = torch.randn(4, 9, requires_grad=True)
        port_ce.softmax_ce_per_example(x, torch.arange(4)).sum().backward()
        assert (port_ce.ce_forward.launches, port_ce.ce_backward.launches,
                port_ce.softmax_ce_per_example.launches) == before


class TestImplRule:
    @pytest.mark.parametrize('impl', ['cuda', 'pallas'])
    def test_kernel_impls_refuse_cpu_tensors(self, impl):
        with pytest.raises(ValueError, match='needs CUDA tensors'):
            port_ce.softmax_ce_per_example(torch.zeros(2, 4),
                                           torch.zeros(2), impl=impl)

    @pytest.mark.parametrize('impl,kw', [
        ('auto', {}), ('interpret', {}), ('pallas', {'interpret': True}),
        ('dense', {})])
    def test_cpu_impls_agree(self, impl, kw):
        logits, labels, _ = _case(8, 33, seed=5)
        x, y = torch.from_numpy(logits), torch.from_numpy(labels)
        want = port_ce.reference_ce(x, y.long(), 1e-4, 0.1)
        got = port_ce.softmax_ce_per_example(x, y, impl=impl, z_loss=1e-4,
                                             label_smoothing=0.1, **kw)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    def test_unknown_impl_and_bad_shapes_raise(self):
        with pytest.raises(ValueError, match='unknown impl'):
            port_ce.ce_forward(torch.zeros(2, 4), torch.zeros(2),
                               impl='triton')
        with pytest.raises(ValueError, match=r'\[N, V\]'):
            port_ce.softmax_ce_per_example(torch.zeros(4), torch.zeros(4))
        with pytest.raises(ValueError, match='labels'):
            port_ce.softmax_ce_per_example(torch.zeros(2, 4),
                                           torch.zeros(3))
        with pytest.raises(ValueError, match="out= is the kernel's"):
            port_ce.ce_forward(torch.zeros(2, 4), torch.zeros(2),
                               out=(torch.zeros(2), torch.zeros(2)))


class TestLmLoss:
    SPEC = {'name': 'transformer_lm', 'vocab_size': 1000, 'd_model': 48,
            'n_layers': 2, 'n_heads': 4, 'd_ff': 96, 'max_seq_len': 17,
            'dtype': 'float32', 'attn_impl': 'dense'}

    @pytest.mark.parametrize('z_loss,smoothing', [(0.0, 0.0), (1e-4, 0.1)])
    def test_lm_ce_with_matches_jax_dense(self, z_loss, smoothing):
        """The loss and its gradient with respect to the logits through a
        2-layer LM from the same weights: B(T-1) = 3·16 = 48 rows of
        V = 1000, a shape the TPU kernel cannot tile (``lm_ce_with(impl=
        'pallas')`` cannot run on the CPU in the JAX package: it never
        interprets), so JAX's dense formulation is the reference. f32,
        F32_TOL on the loss; the logits' gradient to 1e-7 absolute (its
        entries are ~1e-3 / 48)."""
        tokens = np.random.RandomState(7).randint(0, 1000, (3, 17)) \
            .astype(np.int32)
        jmodel = jax_create_model(**self.SPEC)
        variables = jmodel.init(jax.random.PRNGKey(0), tokens[:1])
        params = jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))
        jlogits = jmodel.apply({'params': params}, tokens)
        jfn = jax_loop.lm_ce_with(z_loss, smoothing, impl='dense')
        (jloss, jmetrics), jdl = jax.value_and_grad(
            lambda lg: jfn(lg, tokens), has_aux=True)(jlogits)

        model = create_model(**self.SPEC, device='cpu')
        model.load_state_dict(params_from_jax(params))
        logits = model(torch.from_numpy(tokens)).detach().requires_grad_()
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), rtol=1e-4,
                                   atol=1e-5)
        fn = port_loop.loss_for_task({'name': 'lm_ce', 'impl': 'auto',
                                      'z_loss': z_loss,
                                      'label_smoothing': smoothing})
        loss, metrics = fn(logits, torch.from_numpy(tokens))
        dl, = torch.autograd.grad(loss, logits)
        assert float(loss.detach()) == pytest.approx(float(jloss),
                                                     rel=F32_TOL)
        assert float(metrics['accuracy']) == pytest.approx(
            float(jmetrics['accuracy']))
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=1e-4,
                                   atol=1e-7)
        assert not dl[:, -1].any()        # the last position has no target


class TestCardChecks:
    """What the card-side checks of the CE kernels rest on, on the CPU."""

    @pytest.mark.parametrize('fault', sorted(kernel_faults.CE_FAULTS))
    def test_planted_fault_edits_the_shipped_source_once(self, fault):
        path = os.path.join(_build.CSRC_DIR, kernel_faults.CE_KERNEL + '.cu')
        with open(path) as fh:
            text = fh.read()
        for old, new in kernel_faults.CE_FAULTS[fault]:
            assert text.count(old) == 1 and new != old

    def test_kernel_source_names_what_it_replaces(self):
        with open(os.path.join(_build.CSRC_DIR, 'fused_ce.cu')) as fh:
            head = fh.read(4000)
        for text in ('`_ce_fwd_kernel`', '`_ce_bwd_kernel`',
                     'mlcomp_tpu/ops/fused_ce.py', 'sm_90a', '3.35 TB/s'):
            assert text in head
        assert 'fused_ce' in _build.kernel_names()

    def test_check_shapes_hold_the_main_path(self):
        # the wide LM's step: B(T-1) = 8191 rows of V = 32768 in bf16,
        # with each (z, ε) pair; bench_fused_ce's shape; ragged V
        step = [s for s in kernel_check.CE_SHAPES if s[:3] == (
            8191, 32768, torch.bfloat16)]
        assert kernel_check.CE_SHAPES[:4] == step
        assert {s[3:5] for s in step} == {(z, e) for z in (0.0, 1e-4)
                                          for e in (0.0, 0.1)}
        assert (8192, 32768, torch.bfloat16, 1e-4, 0.1, 0) in \
            kernel_check.CE_SHAPES
        assert {1, 127, 50257} <= {s[1] for s in kernel_check.CE_SHAPES}
        assert any(s[5] for s in kernel_check.CE_SHAPES)

    def test_inputs_on_the_cpu(self):
        gen = torch.Generator().manual_seed(0)
        x, labels, g = kernel_check.ce_inputs(5, 11, torch.bfloat16, gen,
                                              'cpu', pad=2)
        assert x.shape == (5, 11) and x.stride() == (13, 1)
        assert x.dtype == torch.bfloat16 and g.shape == (5,)
        assert labels.min() >= -3 and labels.max() < 14

"""The port's fused batch-norm backward against the JAX package's, on the
CPU, and the card-side checks of its kernel.

The same inputs, made with numpy from a seed, go through JAX's
``_fused_bwd`` (the jnp backward of ``fused_norm_act``'s custom_vjp) and
the port's ``norm_act_backward``, the backward kernel's plain version:
bf16 and f32 rows, ragged channel counts and a mask-heavy case with
beta < 0. The CUDA kernel itself (``csrc/fused_norm_bwd.cu``) runs only
on the card; ``chip_smoke.py`` holds it against the plain version there
with ``kernel_check.norm_bwd_check``, which runs here on the plain
version and on a planted wrong gradient.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.ops.fused_norm import _fused_bwd
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import fused_norm as port_norm
from mlcomp_tpu_torch.testing import kernel_check, kernel_faults
from mlcomp_tpu_torch.testing import kernel_variants

EPS = 1e-5


def _inputs(r, c, seed, beta_shift=0.0):
    """x with a per-channel mean and spread, gamma in [0.5, 1.5), beta
    normal(0, 0.5) moved by ``beta_shift``, dy standard normal."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(r, c) * rng.uniform(0.5, 1.5, c)
         + rng.uniform(-1, 2, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.randn(c) * 0.5 + beta_shift).astype(np.float32)
    dy = rng.randn(r, c).astype(np.float32)
    return x, gamma, beta, dy


def _both(x, gamma, beta, dy, act, dtype):
    """(port, jax) results of the backward in ``dtype`` rows from the
    same inputs and the same f32 statistics, as f32 numpy arrays."""
    xt = torch.from_numpy(x).to(dtype)
    dyt = torch.from_numpy(dy).to(dtype)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    _, mean, var = port_norm.reference_norm_act(xt, g, b, eps=EPS)
    port = port_norm.norm_act_backward(xt, g, b, mean, var, dyt, EPS, act)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    res = (jnp.asarray(xt.float().numpy()).astype(jdtype), jnp.asarray(gamma),
           jnp.asarray(beta), jnp.asarray(mean.numpy()),
           jnp.asarray(var.numpy()))
    cot = (jnp.asarray(dyt.float().numpy()).astype(jdtype), None, None)
    want = _fused_bwd(EPS, act, 'interpret', 1024, res, cot)
    return ([t.float().numpy() for t in port],
            [np.asarray(a, dtype=np.float32) for a in want])


class TestAgainstJax:
    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize('c', [3, 100])
    @pytest.mark.parametrize('act', [True, False])
    def test_ragged_channels(self, dtype, c, act):
        got, want = _both(*_inputs(257, c, seed=c), act, dtype)
        self._close(got, want, dtype)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
    def test_mask_heavy(self, dtype):
        """beta < 0 in every channel: the ReLU is off for most rows."""
        x, gamma, beta, dy = _inputs(200, 16, seed=7, beta_shift=-1.5)
        assert (beta < 0).all()
        got, want = _both(x, gamma, beta, dy, True, dtype)
        # most of dx is the centring terms alone where the mask is off
        self._close(got, want, dtype)

    @staticmethod
    def _close(got, want, dtype):
        for name, g, w in zip(('dx', 'dgamma', 'dbeta'), got, want):
            if name == 'dx' and dtype == torch.bfloat16:
                # both round an f32 dx to bf16 (2^-8): a rounding edge
                # apart at most
                np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                           err_msg=name)


class TestWrapper:
    def _args(self, r=16, c=8):
        x, gamma, beta, dy = (torch.from_numpy(a)
                              for a in _inputs(r, c, seed=1))
        _, mean, var = port_norm.reference_norm_act(x, gamma, beta)
        return x, gamma, beta, mean, var, dy

    def test_cpu_tensor_takes_the_plain_version_uncounted(self):
        before = (port_norm.norm_act_backward_kernel.launches,
                  port_norm.norm_act_backward_kernel.copies)
        args = self._args()
        got = port_norm.norm_act_backward_kernel(*args, EPS, True)
        want = port_norm.norm_act_backward(*args, EPS, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (port_norm.norm_act_backward_kernel.launches,
                port_norm.norm_act_backward_kernel.copies) == before

    @pytest.mark.parametrize('impl', ['cuda', 'pallas'])
    def test_kernel_impl_on_a_cpu_tensor_raises(self, impl):
        x, gamma, beta, _, _, _ = self._args()
        with pytest.raises(ValueError, match='CUDA'):
            port_norm.fused_norm_act(x.requires_grad_(), gamma, beta,
                                     impl=impl)

    @pytest.mark.parametrize('bad', ['dy_shape', 'mean_shape', 'var_shape',
                                     'dy_dtype', 'x_dtype'])
    def test_bad_shapes_and_dtypes_raise(self, bad):
        x, gamma, beta, mean, var, dy = self._args()
        if bad == 'dy_shape':
            dy = dy[:-1]
        elif bad == 'mean_shape':
            mean = mean[:-1]
        elif bad == 'var_shape':
            var = var.repeat(2)
        elif bad == 'dy_dtype':
            dy = dy.bfloat16()
        else:
            x, dy = x.double(), dy.double()
        with pytest.raises(ValueError):
            port_norm.norm_act_backward_kernel(x, gamma, beta, mean, var,
                                               dy, EPS, True)

    @pytest.mark.parametrize('impl,plain', [('auto', False),
                                            ('dense', True)])
    def test_autograd_backward_takes_the_wrapper(self, impl, plain,
                                                 monkeypatch):
        """``FusedNormAct``'s backward goes through the kernel's wrapper
        (which takes the plain version for a CPU tensor), or straight to
        the plain version with ``impl='dense'``."""
        calls = []
        real = port_norm.norm_act_backward_kernel

        def spy(*args):
            calls.append(args)
            return real(*args)
        monkeypatch.setattr(port_norm, 'norm_act_backward_kernel', spy)
        x, gamma, beta, _, _, dy = self._args()
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        y, _, _ = port_norm.fused_norm_act(*leaves, impl=impl)
        (y * dy).sum().backward()
        assert len(calls) == (0 if plain else 1)
        assert all(t.grad is not None for t in leaves)


class TestCardChecks:
    @pytest.mark.parametrize('shape', [(100, 12, torch.float32, True),
                                       (8, 1000, torch.float32, False),
                                       (1, 100, torch.float32, False),
                                       (777, 3, torch.float16, True),
                                       (2048, 64, torch.bfloat16, True)])
    def test_check_passes_the_f32_plain_version(self, shape):
        """On the CPU the wrapper is the f32 plain version, which the
        check holds to the f64 one within the bounds."""
        gen = torch.Generator().manual_seed(2)
        r = kernel_check.norm_bwd_check(shape, gen, device='cpu')
        assert r['finite'] and kernel_check.norm_bwd_ok(r, shape), r

    @staticmethod
    def _without_dbeta(x, gamma, beta, mean, var, dy, eps, act):
        """The plain backward with dx's -dbeta/R term dropped."""
        dx, dgamma, dbeta = port_norm.norm_act_backward(
            x, gamma, beta, mean, var, dy, eps, act)
        inv = torch.rsqrt(var + eps)
        return ((dx.float() + inv * gamma * dbeta / x.shape[0]).to(x.dtype),
                dgamma, dbeta)

    @staticmethod
    def _dgamma_over_x(x, gamma, beta, mean, var, dy, eps, act):
        """The plain backward with dgamma summed over x, not xhat."""
        dx, _, dbeta = port_norm.norm_act_backward(
            x, gamma, beta, mean, var, dy, eps, act)
        return dx, (dy.float() * x.float()).sum(0), dbeta

    @pytest.mark.parametrize('fault', ['_without_dbeta', '_dgamma_over_x'])
    def test_check_sees_a_wrong_gradient(self, fault):
        shape = (1000, 100, torch.float32, False)
        gen = torch.Generator().manual_seed(0)
        r = kernel_check.norm_bwd_check(shape, gen, device='cpu',
                                        fn=getattr(self, fault))
        assert not kernel_check.norm_bwd_ok(r, shape), r

    def test_band_holds_the_mask_flips(self):
        """Where the f32 and f64 pre differ in sign the element lies in
        the band, and the band stays a small share of the elements."""
        shape = (4096, 64, torch.bfloat16, True)
        gen = torch.Generator().manual_seed(3)
        r = kernel_check.norm_bwd_check(shape, gen, device='cpu')
        assert r['flips_outside_band'] == 0
        assert r['band'] <= kernel_check.NORM_BAND_SHARE * 4096 * 64 + \
            kernel_check.NORM_BAND_FLOOR

    @pytest.mark.parametrize('fault', sorted(kernel_faults.NORM_BWD_FAULTS))
    def test_planted_fault_edits_the_shipped_source_once(self, fault):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.NORM_BWD_KERNEL + '.cu')) as fh:
            source = fh.read()
        for old, new in kernel_faults.NORM_BWD_FAULTS[fault]:
            assert source.count(old) == 1 and new != old

    @pytest.mark.parametrize('variant', sorted(kernel_variants.NORM_VARIANTS))
    def test_variant_edits_its_source_once(self, variant):
        right, edits = kernel_variants.NORM_VARIANTS[variant]
        assert right
        for file, old, new in edits:
            with open(os.path.join(_build.CSRC_DIR, file)) as fh:
                assert fh.read().count(old) == 1 and new != old

    def test_norm_faults_count(self):
        assert len(kernel_faults.NORM_BWD_FAULTS) >= 6
        assert {'streamed_rows_left_out_of_stats',
                'resident_tile_applied_to_the_next_block'} <= set(
                    kernel_faults.NORM_FAULTS)

    @pytest.mark.parametrize('name,replaces', [
        ('fused_norm', '_norm_kernel'), ('fused_norm_bwd', '_fused_bwd')])
    def test_kernel_sources_name_what_they_replace(self, name, replaces):
        assert name in _build.kernel_names()
        with open(os.path.join(_build.CSRC_DIR, name + '.cu')) as fh:
            head = fh.read(4000)
        assert replaces in head and 'sm_90a' in head
        assert 'mlcomp_tpu/ops/fused_norm.py' in head and '3.35 TB/s' in head

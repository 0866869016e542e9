"""The port's fused batch-norm+ReLU op against the JAX package's, on the
CPU.

The same inputs, made with numpy from a seed, go through JAX's
``fused_norm_act(impl='interpret')`` (the Pallas kernel under the
interpreter, as ``tests/test_ops.py`` runs it) and the port's
``fused_norm_act``, which on a CPU tensor takes the kernel's plain
version: y, mean and var forward, and the gradients in x, gamma and
beta through the batch statistics. The CUDA kernel itself runs only on
the card; ``chip_smoke.py`` holds it against the plain version there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.ops.fused_norm import fused_norm_act as jax_fused_norm_act
from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import fused_norm as port_norm
from mlcomp_tpu_torch.testing import kernel_check, kernel_faults

#: f32 on both sides: the same statistics in another summation order
F32_TOL = 1e-5


def _inputs(r, c, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(r, c) * rng.uniform(0.5, 1.5, c)
         + rng.uniform(-1, 2, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.randn(c) * 0.5).astype(np.float32)
    cot = rng.randn(r, c).astype(np.float32)
    return x, gamma, beta, cot


def _jax_run(x, gamma, beta, cot, act):
    def loss(x, g, b):
        y, mean, var = jax_fused_norm_act(x, g, b, 1e-5, act, 'interpret')
        return jnp.sum(y * cot), (y, mean, var)
    grads, (y, mean, var) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(a) for a in (y, mean, var, *grads)]


def _port_run(x, gamma, beta, cot, act, impl='auto'):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y, mean, var = port_norm.fused_norm_act(*leaves, 1e-5, act, impl)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    return [t.detach().numpy() for t in (y, mean, var, *grads)]


class TestAgainstJax:
    @pytest.mark.parametrize('c', [8, 16, 128])
    @pytest.mark.parametrize('act', [True, False])
    def test_forward_and_gradients(self, c, act):
        args = _inputs(64, c, seed=c)
        want = _jax_run(*args, act)
        got = _port_run(*args, act)
        for name, g, w in zip(('y', 'mean', 'var', 'dx', 'dgamma', 'dbeta'),
                              got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=name)

    def test_dense_impl_is_the_same_function(self):
        args = _inputs(40, 12, seed=3)
        for a, b in zip(_port_run(*args, True, 'dense'),
                        _port_run(*args, True, 'auto')):
            np.testing.assert_array_equal(a, b)

    def test_stats_path_is_the_eval_formula(self):
        x, gamma, beta, _ = _inputs(32, 8)
        mean = np.full(8, 0.5, np.float32)
        var = np.full(8, 2.0, np.float32)
        y, m, v = port_norm.reference_norm_act(
            *(torch.from_numpy(a) for a in (x, gamma, beta)),
            act=False, stats=(torch.from_numpy(mean), torch.from_numpy(var)))
        want = (x - mean) / np.sqrt(var + 1e-5) * gamma + beta
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
        assert torch.equal(m, torch.from_numpy(mean))

    def test_bf16_rows_keep_their_dtype(self):
        x, gamma, beta, _ = _inputs(16, 8)
        y, mean, var = port_norm.fused_norm_act(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(gamma),
            torch.from_numpy(beta))
        assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
        assert not mean.requires_grad and (y >= 0).all()


class TestWrapper:
    @pytest.mark.parametrize('impl', ['cuda', 'pallas'])
    def test_kernel_impl_needs_the_card(self, impl):
        x, gamma, beta, _ = _inputs(8, 4)
        with pytest.raises(ValueError, match='CUDA'):
            port_norm.fused_norm_act(torch.from_numpy(x),
                                     torch.from_numpy(gamma),
                                     torch.from_numpy(beta), impl=impl)

    @pytest.mark.parametrize('name,want', [('auto', 'auto'),
                                           ('interpret', 'auto'),
                                           ('pallas', 'cuda'),
                                           ('dense', 'dense')])
    def test_impl_names(self, name, want):
        assert port_norm.resolve_norm_impl(name) == want

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match='norm impl'):
            port_norm.resolve_norm_impl('triton')

    @pytest.mark.parametrize('shape,gshape', [((8,), (8,)), ((0, 4), (4,)),
                                              ((8, 4), (5,))])
    def test_bad_shapes_raise(self, shape, gshape):
        with pytest.raises(ValueError):
            port_norm.norm_act_forward(torch.zeros(shape), torch.ones(gshape),
                                       torch.zeros(gshape))

    def test_cpu_tensor_takes_the_plain_version_uncounted(self):
        before = port_norm.norm_act_forward.launches
        x, gamma, beta, _ = _inputs(8, 4)
        port_norm.norm_act_forward(*(torch.from_numpy(a)
                                     for a in (x, gamma, beta)))
        assert port_norm.norm_act_forward.launches == before

class TestCardChecks:
    @pytest.mark.parametrize('batch', [512, 256])
    def test_norm_shapes_hold_the_cifar_sites(self, batch):
        """The step's batch (512) and the executor's (256): both acts at
        each of the four site shapes, in bf16."""
        sites = kernel_check.cifar_norm_sites(batch)
        assert sites[0] == (batch * 32 * 32, 64) and sites[-1][1] == 512
        shapes = set(kernel_check.NORM_SHAPES)
        assert {(r, c, torch.bfloat16, act) for r, c in sites
                for act in (True, False)} <= shapes
        assert kernel_check.NORM_SHAPES[0] == (524288, 64, torch.bfloat16,
                                               True)

    def test_norm_shapes_ragged(self):
        shapes = kernel_check.NORM_SHAPES
        ragged = {(r, c) for r, c, d, _ in shapes if d != torch.bfloat16}
        assert ragged == {(r, c) for r in (1, 8, 777, 1000)
                          for c in (3, 100, 1000)}
        assert len(shapes) == 16 + 24

    @pytest.mark.parametrize('batch', [1, 2])
    def test_cifar_sites_are_the_model_s(self, batch, monkeypatch):
        """ResNet-18 at full width on 32x32 images hands the fused norm
        exactly the [R, C] rows and acts the site table lists."""
        from collections import Counter

        from mlcomp_tpu_torch.models import create_model, resnet
        seen = Counter()
        real = resnet.fused_norm_act

        def spy(rows, *args):
            seen[(*rows.shape, args[3])] += 1
            return real(rows, *args)
        monkeypatch.setattr(resnet, 'fused_norm_act', spy)
        model = create_model(name='resnet18', num_classes=10,
                             dtype='float32', norm='fused', device='cpu')
        x = torch.from_numpy(np.random.RandomState(0).rand(
            batch, 32, 32, 3).astype(np.float32))
        with torch.no_grad():
            model(x, train=True)
        want = Counter()
        for (r, c), (n_act, n_plain) in zip(
                kernel_check.cifar_norm_sites(batch),
                kernel_check.CIFAR_SITE_ACTS):
            want[(r, c, True)] += n_act
            want[(r, c, False)] += n_plain
        assert seen == want and sum(seen.values()) == 20

    @pytest.mark.parametrize('shape', [(100, 12, torch.float32, True),
                                       (8, 1000, torch.float32, False),
                                       (777, 3, torch.float16, True)])
    def test_check_passes_the_f32_plain_version(self, shape):
        """On the CPU the wrapper is the f32 plain version, which the
        check holds to the f64 one within the bounds."""
        gen = torch.Generator().manual_seed(2)
        r = kernel_check.norm_check(shape, gen, device='cpu')
        assert r['finite'] and kernel_check.norm_ok(r, shape[2]), r

    def test_check_sees_a_wrong_variance(self):
        gen = torch.Generator().manual_seed(0)
        x, gamma, beta = kernel_check.norm_inputs(8, 16, torch.float32, gen,
                                                  device='cpu')
        y, mean, var = port_norm.reference_norm_act(x, gamma, beta)
        # the unbiased variance at R=8: 8/7 of the biased one
        assert float(((var * 8 / 7 - var).abs()
                      / x.square().mean(0)).max()) > kernel_check.NORM_STAT_TOL

    @pytest.mark.parametrize('fault', sorted(kernel_faults.NORM_FAULTS))
    def test_planted_fault_edits_the_shipped_source_once(self, fault):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.NORM_KERNEL + '.cu')) as fh:
            source = fh.read()
        for old, new in kernel_faults.NORM_FAULTS[fault]:
            assert source.count(old) == 1 and new != old

    def test_kernel_source_names_what_it_replaces(self):
        assert 'fused_norm' in _build.kernel_names()
        with open(os.path.join(_build.CSRC_DIR, 'fused_norm.cu')) as fh:
            head = fh.read(4000)
        assert '_norm_kernel' in head and 'sm_90a' in head
        assert '3.35 TB/s' in head

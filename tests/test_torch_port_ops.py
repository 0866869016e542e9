"""The port's flash-attention op against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through JAX's
``fused_attention(impl='interpret')`` (the Pallas kernel under the
interpreter, as ``tests/test_ops.py`` runs it) and the port's
``fused_attention``, which on a CPU tensor takes the kernel's plain
version. The CUDA kernel itself runs only on the card; ``chip_smoke.py``
holds it against the plain version there.
"""

import os

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import flash_attention as port_fa
from mlcomp_tpu_torch.testing import kernel_check, kernel_faults

#: f32 on both sides: the same tolerance as tests/test_ops.py
F32_TOL = 2e-5


def _qkv(b=2, t=256, h=4, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))


def _jax(fn, *arrays, **kw):
    import jax.numpy as jnp
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _port(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


class TestAgainstJax:
    @pytest.mark.parametrize('causal', [True, False])
    def test_fused_attention_matches_interpreted_kernel(self, causal):
        from mlcomp_tpu.ops.flash_attention import fused_attention
        q, k, v = _qkv()
        ref = _jax(fused_attention, q, k, v, causal=causal,
                   impl='interpret')
        out = _port(port_fa.fused_attention, q, k, v, causal=causal)
        assert np.abs(out - ref).max() < F32_TOL

    def test_multi_block_seq(self):
        """T=256 in 128-row blocks: the JAX kernel accumulates over two
        k-blocks with a causally dead tile skipped."""
        from mlcomp_tpu.ops.flash_attention import flash_attention_forward
        q, k, v = _qkv(b=1, t=256, h=2, d=64, seed=1)
        ref = _jax(flash_attention_forward, q, k, v, causal=True,
                   block_q=128, block_k=128, interpret=True)
        out = _port(port_fa.flash_attention_forward, q, k, v, causal=True)
        assert np.abs(out - ref).max() < F32_TOL

    @pytest.mark.parametrize('causal', [True, False])
    def test_scale_override(self, causal):
        from mlcomp_tpu.ops.flash_attention import flash_attention_forward
        q, k, v = _qkv(b=1, t=128, h=2, d=32, seed=2)
        ref = _jax(flash_attention_forward, q, k, v, causal=causal,
                   scale=0.3, block_q=128, block_k=128, interpret=True)
        out = _port(port_fa.fused_attention, q, k, v, causal=causal,
                    scale=0.3)
        assert np.abs(out - ref).max() < F32_TOL

    def test_reference_matches_jax_reference_in_bf16(self):
        """Both plain versions score in f32 from bf16 inputs and round
        the output to bf16: one bf16 ulp (2^-8 relative) apart at most."""
        import jax.numpy as jnp
        from mlcomp_tpu.ops.flash_attention import reference_attention
        q, k, v = _qkv(b=1, t=128, h=2, d=64, seed=3)
        ref = np.asarray(reference_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
            np.float32)
        out = port_fa.reference_attention(
            *(torch.from_numpy(a).bfloat16() for a in (q, k, v))).float()
        assert np.abs(out.numpy() - ref).max() <= 2 ** -8 * (
            1 + np.abs(ref).max())


class TestWrapper:
    def test_cpu_tensor_takes_plain_version_without_launch(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, t=64, h=2, d=16))
        before = port_fa.flash_attention_forward.launches
        out = port_fa.flash_attention_forward(q, k, v)
        torch.testing.assert_close(
            out, port_fa.reference_attention(q, k, v), rtol=0, atol=0)
        assert port_fa.flash_attention_forward.launches == before

    def test_ragged_length_any_t(self):
        """No T % 128 rule in the port (the CUDA kernel masks the ragged
        edge): the plain path agrees with a dense causal softmax."""
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, t=77, h=2, d=8))
        out = port_fa.fused_attention(q, k, v)
        s = torch.einsum('bqhd,bkhd->bhqk', q, k) * 8 ** -0.5
        s = s.masked_fill(torch.ones(77, 77).tril() == 0, float('-inf'))
        ref = torch.einsum('bhqk,bkhd->bqhd', s.softmax(-1), v)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)

    def test_other_devices_raise_instead_of_falling_back(self):
        q = torch.empty((1, 8, 2, 64), device='meta')
        with pytest.raises(ValueError, match='runs on cuda'):
            port_fa.flash_attention_forward(q, q, q)

    @pytest.mark.parametrize('impl,calls', [
        ('auto', 'forward'), ('interpret', 'forward'), ('dense', 'plain')])
    def test_impl_selection(self, impl, calls, monkeypatch):
        seen = []
        monkeypatch.setattr(port_fa, 'flash_attention_forward',
                            lambda *a, **k: seen.append('forward'))
        monkeypatch.setattr(port_fa, 'reference_attention',
                            lambda *a, **k: seen.append('plain'))
        q = torch.zeros((1, 4, 1, 8))
        port_fa.fused_attention(q, q, q, impl=impl)
        assert seen == [calls]

    @pytest.mark.parametrize('impl', ['cuda', 'pallas'])
    def test_kernel_impl_needs_cuda_tensors(self, impl):
        q = torch.zeros((1, 4, 1, 8))
        with pytest.raises(ValueError, match="'cuda' needs CUDA"):
            port_fa.fused_attention(q, q, q, impl=impl)

    def test_unknown_impl_raises(self):
        q = torch.zeros((1, 4, 1, 8))
        with pytest.raises(ValueError, match='attn impl'):
            port_fa.fused_attention(q, q, q, impl='triton')

    @pytest.mark.parametrize('shape,dtype,match', [
        ((1, 8, 2, 48), torch.bfloat16, 'head_dim'),
        ((1, 8, 2, 64), torch.float64, 'float32, bfloat16 or float16'),
        ((1, 8, 2, 256), torch.float16, 'head_dim'),
    ])
    def test_kernel_refuses_what_it_does_not_take(self, shape, dtype,
                                                  match):
        with pytest.raises(ValueError, match=match):
            port_fa.check_kernel_inputs(torch.empty(shape, dtype=dtype))

    @pytest.mark.parametrize('scale', [-0.3, 0.0])
    def test_kernel_takes_a_nonpositive_scale_through_q(self, scale):
        """The kernel finds the row max on unscaled scores, so it takes a
        positive scale; the wrapper folds a negative one's sign into q
        and a zero one into zero queries, which give the same scores."""
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, t=64, h=2, d=16))
        q2, scale2 = port_fa._kernel_scale(q, scale)
        assert scale2 > 0
        for causal in (True, False):
            torch.testing.assert_close(
                port_fa.reference_attention(q2, k, v, causal, scale2),
                port_fa.reference_attention(q, k, v, causal, scale),
                rtol=1e-6, atol=1e-6)
        assert port_fa._kernel_scale(q, 0.125) == (q, 0.125)

    @pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                       torch.float16])
    @pytest.mark.parametrize('d', port_fa.KERNEL_HEAD_DIMS)
    def test_kernel_takes_its_dtypes_and_head_dims(self, dtype, d):
        port_fa.check_kernel_inputs(torch.empty((2, 8, 2, d), dtype=dtype))

    @pytest.mark.parametrize('name,impl', [
        ('auto', 'auto'), ('dense', 'dense'), ('cuda', 'cuda'),
        ('pallas', 'cuda'), ('interpret', 'auto')])
    def test_resolve_impl(self, name, impl):
        assert port_fa.resolve_impl(name) == impl

    def test_resolve_impl_refuses_other_names(self):
        with pytest.raises(ValueError, match="attn_impl must be one of"):
            port_fa.resolve_impl('triton')

    def test_mismatched_inputs_raise(self):
        q = torch.zeros((1, 4, 2, 8))
        with pytest.raises(ValueError, match='shapes differ'):
            port_fa.flash_attention_forward(q, q[:, :2], q)
        with pytest.raises(ValueError, match='dtypes differ'):
            port_fa.flash_attention_forward(q, q.double(), q)

    def test_qkv_views_keep_their_strides(self):
        """The model hands the kernel strided views into one qkv
        projection; 16-bit views whose rows sit on 16-byte boundaries go
        to the kernel as they are, others are copied first."""
        qkv = torch.zeros((2, 16, 3, 4, 64), dtype=torch.bfloat16)
        q, k, v = qkv.unbind(2)
        if qkv.data_ptr() % 16 == 0:
            assert port_fa._kernel_operand(k).data_ptr() == k.data_ptr()
        odd = torch.zeros(2 * 16 * 4 * 64 + 1,
                          dtype=torch.bfloat16)[1:].view(2, 16, 4, 64)
        copied = port_fa._kernel_operand(odd)
        assert copied.data_ptr() % 16 == 0 and copied.is_contiguous()
        f32 = torch.zeros((2, 16, 3, 4, 8)).unbind(2)[1]
        assert port_fa._kernel_operand(f32).data_ptr() == f32.data_ptr()


class TestRoundedReference:
    """``reference_attention(round_p=True)``: the kernel's numerics,
    which the card-side check holds the kernel to."""

    @pytest.mark.parametrize('causal', [True, False])
    def test_f32_is_the_plain_softmax(self, causal):
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=2, t=96, h=2, d=32))
        torch.testing.assert_close(
            port_fa.reference_attention(q, k, v, causal, round_p=True),
            port_fa.reference_attention(q, k, v, causal),
            rtol=1e-5, atol=1e-6)

    def test_bf16_rounds_p_before_the_pv_product(self):
        q, k, v = (torch.from_numpy(a).bfloat16()
                   for a in _qkv(b=1, t=64, h=2, d=32, seed=4))
        s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * 32 ** -0.5
        s = s.masked_fill(torch.ones(64, 64).tril() == 0, port_fa.NEG_INF)
        p = (s - s.amax(-1, keepdim=True)).exp()
        want = torch.einsum('bhqk,bkhd->bqhd', p.bfloat16().float(),
                            v.float()) / p.sum(-1).transpose(1, 2)[..., None]
        got = port_fa.reference_attention(q, k, v, round_p=True)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
        plain = port_fa.reference_attention(q, k, v)
        assert kernel_check.row_relative_error(got, plain) < 2 ** -7


class TestKernelCheck:
    """The card-side bound reads each output row against its own size,
    so a fault in deep rows of a long sequence shows (at a CPU size)."""

    def _deep_fault(self, t=2048, skip=(64, 128), from_row=1024):
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, t=t, h=2, d=64))
        ref = port_fa.reference_attention(q, k, v)
        s = torch.einsum('bqhd,bkhd->bhqk', q, k) * 64 ** -0.5
        keep = torch.ones(t, t).tril().bool()
        keep[from_row:, skip[0]:skip[1]] = False
        p = s.masked_fill(~keep, float('-inf')).softmax(-1)
        return torch.einsum('bhqk,bkhd->bqhd', p, v), ref

    def test_deep_row_fault_breaks_the_row_bound(self):
        faulty, ref = self._deep_fault()
        tol = kernel_check.ATTENTION_ROW_TOL[torch.bfloat16]
        assert kernel_check.row_relative_error(faulty, ref) > 5 * tol

    def test_clean_output_reads_zero(self):
        _, ref = self._deep_fault()
        assert kernel_check.row_relative_error(ref, ref) == 0.0

    def test_non_finite_output_fails_any_bound(self):
        _, ref = self._deep_fault(t=128)
        bad = ref.clone()
        bad[0, 5, 1, 3] = float('nan')
        assert not kernel_check.row_relative_error(bad, ref) <= 1.0

    def test_shapes_start_with_the_serving_shape(self):
        assert kernel_check.ATTENTION_SHAPES[0] == (
            4, 8192, 16, 64, torch.bfloat16, True)
        for shape in kernel_check.ATTENTION_SHAPES:
            assert shape[3] in port_fa.KERNEL_HEAD_DIMS
            assert shape[4] in kernel_check.ATTENTION_ROW_TOL

    def test_qkv_views_are_strided_views(self):
        gen = torch.Generator().manual_seed(0)
        q, k, v = kernel_check.qkv_views(2, 5, 3, 32, torch.bfloat16, gen,
                                         device='cpu')
        assert q.shape == (2, 5, 3, 32) and not q.is_contiguous()
        assert k.data_ptr() - q.data_ptr() == 3 * 32 * 2

    @pytest.mark.parametrize('fault', sorted(kernel_faults.FAULTS))
    def test_planted_fault_edits_the_shipped_source_once(self, fault):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.KERNEL + '.cu')) as fh:
            source = fh.read()
        old, new = kernel_faults.FAULTS[fault]
        assert source.count(old) == 1 and new != old


class TestBuild:
    def test_sources_listed(self):
        assert 'flash_attention_fwd' in _build.kernel_names()

    def test_targets_hopper(self):
        flags = ' '.join(_build.NVCC_FLAGS)
        assert 'arch=compute_90a,code=sm_90a' in flags
        assert '-shared' in flags and '-fPIC' in flags

    def test_key_follows_source(self, tmp_path, monkeypatch):
        src = tmp_path / 'k.cu'
        src.write_text('// one')
        monkeypatch.setattr(_build, 'CSRC_DIR', str(tmp_path))
        first = _build.source_key('k')
        assert _build.source_key('k') == first
        src.write_text('// two')
        assert _build.source_key('k') != first
        monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / 'out'))
        assert _build.library_path('k').startswith(str(tmp_path / 'out'))

    def test_missing_nvcc_is_a_clear_error(self, monkeypatch, tmp_path):
        monkeypatch.setenv('PATH', str(tmp_path))
        monkeypatch.setenv('CUDA_HOME', str(tmp_path))
        monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / 'out'))
        if os.path.exists('/usr/local/cuda/bin/nvcc'):
            pytest.skip('a CUDA toolkit is installed at /usr/local/cuda')
        with pytest.raises(RuntimeError, match='nvcc not found'):
            _build.build(['flash_attention_fwd'])

    def test_kernel_source_names_what_it_replaces(self):
        with open(os.path.join(_build.CSRC_DIR,
                               'flash_attention_fwd.cu')) as fh:
            head = fh.read(4000)
        assert '_fa_kernel' in head and 'sm_90a' in head
        assert '989 TFLOP/s' in head and '3.35 TB/s' in head

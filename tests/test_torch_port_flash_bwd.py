"""The port's flash-attention lse and backward against the JAX package's,
on the CPU.

The same inputs, made with numpy from a seed, go through the JAX kernels
under the Pallas interpreter (``interpret=True``, as ``tests/test_ops.py``
runs them) and through the port's wrappers, which on CPU tensors take
their plain versions (``reference_attention(with_lse=True)``,
``reference_attention_backward``: P and dS rounded to the input dtype as
the kernels round them). The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions.
"""

import os

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops import flash_attention as port_fa
from mlcomp_tpu_torch.ops import fused_ce as port_ce
from mlcomp_tpu_torch.testing import (
    kernel_check, kernel_faults, kernel_variants,
)

#: f32 on both sides: summation order only (measured max |diff| of the
#: gradients ~3e-6, of the lse ~5e-7)
F32_TOL = 1e-5
B, T, H, D = 2, 256, 2, 64      # two 128-row blocks of the JAX kernels


def _arrays(n=4, b=B, t=T, h=H, d=D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(n)]


def _jax_residuals(q, k, v, causal, dtype=None):
    import jax.numpy as jnp
    from mlcomp_tpu.ops.flash_attention import flash_attention_forward
    args = [jnp.asarray(a, dtype or jnp.float32) for a in (q, k, v)]
    out, lse = flash_attention_forward(*args, causal=causal, block_q=128,
                                       block_k=128, interpret=True,
                                       with_lse=True)
    return args, out, lse


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


class TestLse:
    @pytest.mark.parametrize('causal', [True, False])
    def test_lse_matches_interpreted_kernel(self, causal):
        q, k, v = _arrays(3)
        _, out, lse = _jax_residuals(q, k, v, causal)
        p_out, p_lse = port_fa.flash_attention_forward(
            *(_torch(a) for a in (q, k, v)), causal=causal, with_lse=True)
        assert p_lse.shape == (B, H, T) and p_lse.dtype == torch.float32
        assert np.abs(p_lse.numpy() - np.asarray(lse)).max() < F32_TOL
        assert np.abs(p_out.numpy() - np.asarray(out)).max() < F32_TOL

    def test_lse_is_the_row_logsumexp_of_the_scaled_scores(self):
        q, k, v = (_torch(a) for a in _arrays(3, t=70, d=32, seed=1))
        _, lse = port_fa.reference_attention(q, k, v, scale=0.3,
                                             with_lse=True)
        s = torch.einsum('bqhd,bkhd->bhqk', q, k) * 0.3
        s = s.masked_fill(torch.ones(70, 70).tril() == 0, float('-inf'))
        torch.testing.assert_close(lse, torch.logsumexp(s, -1),
                                   rtol=1e-6, atol=1e-6)

    def test_lse_error_is_relative_to_at_least_one(self):
        ref = torch.tensor([0.0, 10.0])
        assert kernel_check.lse_error(ref + 1e-6, ref) == pytest.approx(
            1e-6, rel=1e-2)
        assert kernel_check.lse_error(ref.clone().fill_(float('nan')),
                                      ref) != 0.0


class TestBackwardAgainstJax:
    @pytest.mark.parametrize('causal', [True, False])
    def test_f32_gradients_match_the_interpreted_kernels(self, causal):
        import jax.numpy as jnp
        from mlcomp_tpu.ops.flash_attention import flash_attention_backward
        q, k, v, do = _arrays()
        args, out, lse = _jax_residuals(q, k, v, causal)
        want = flash_attention_backward(*args, out, lse, jnp.asarray(do),
                                        causal=causal, block_q=128,
                                        block_k=128, interpret=True)
        got = port_fa.flash_attention_backward(
            *(_torch(a) for a in (q, k, v)), _torch(out), _torch(lse),
            _torch(do), causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.abs(g.numpy() - np.asarray(w)).max() < F32_TOL

    @pytest.mark.parametrize('causal', [True, False])
    def test_bf16_gradients_match_by_row_and_head(self, causal):
        """Both round P and dS to bf16 and the outputs to bf16; f32 sums
        taken in another order flip a rounding now and then, which the
        card-side bounds for the kernels allow too (measured here: row
        error ≤ 3.3e-3, head error ≤ 1.8e-4 over three seeds)."""
        import jax.numpy as jnp
        from mlcomp_tpu.ops.flash_attention import flash_attention_backward
        q, k, v, do = _arrays(seed=1)
        args, out, lse = _jax_residuals(q, k, v, causal, jnp.bfloat16)
        want = [_torch(w) for w in flash_attention_backward(
            *args, out, lse, jnp.asarray(do, jnp.bfloat16), causal=causal,
            block_q=128, block_k=128, interpret=True)]
        got = port_fa.flash_attention_backward(
            *(_torch(a, torch.bfloat16) for a in (q, k, v)),
            _torch(out, torch.bfloat16), _torch(lse),
            _torch(do, torch.bfloat16), causal=causal)
        floor = kernel_check.BACKWARD_ROW_FLOOR * max(
            kernel_check._rms_row(w) for w in want)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            assert kernel_check.row_relative_error(g, w, floor) <= \
                kernel_check.BACKWARD_ROW_TOL[torch.bfloat16]
            assert kernel_check.head_relative_error(g, w) <= \
                kernel_check.BACKWARD_HEAD_TOL[torch.bfloat16]

    @pytest.mark.parametrize('causal', [True, False])
    def test_autograd_through_fused_attention_matches_jax_grad(self, causal):
        import jax
        import jax.numpy as jnp
        from mlcomp_tpu.ops.flash_attention import fused_attention
        q, k, v, do = _arrays(seed=2)

        def f(q_, k_, v_):
            return jnp.sum(fused_attention(q_, k_, v_, causal=causal,
                                           impl='interpret')
                           * jnp.asarray(do))

        want = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
        leaves = [_torch(a).requires_grad_() for a in (q, k, v)]
        port_fa.fused_attention(*leaves, causal=causal).backward(_torch(do))
        for x, w in zip(leaves, want):
            assert np.abs(x.grad.numpy() - np.asarray(w)).max() < F32_TOL


class TestBackwardWrapper:
    def test_cpu_tensors_take_the_plain_version_without_launches(self):
        q, k, v, do = (_torch(a) for a in _arrays(t=64, d=16))
        out, lse = port_fa.flash_attention_forward(q, k, v, with_lse=True)
        before = (port_fa.flash_attention_backward_dq.launches,
                  port_fa.flash_attention_backward_dkv.launches,
                  port_fa.flash_attention_forward.launches)
        got = port_fa.flash_attention_backward(q, k, v, out, lse, do)
        want = port_fa.reference_attention_backward(q, k, v, out, lse, do)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert before == (port_fa.flash_attention_backward_dq.launches,
                          port_fa.flash_attention_backward_dkv.launches,
                          port_fa.flash_attention_forward.launches)

    @pytest.mark.parametrize('scale', [0.3, -0.3, 0.0])
    def test_plain_backward_is_the_gradient_for_any_scale(self, scale):
        q, k, v, do = (_torch(a) for a in _arrays(t=48, d=16, seed=3))
        out, lse = port_fa.reference_attention(q, k, v, scale=scale,
                                               with_lse=True)
        got = port_fa.reference_attention_backward(q, k, v, out, lse, do,
                                                   scale=scale)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        port_fa.reference_attention(*leaves, scale=scale).backward(do)
        for g, x in zip(got, leaves):
            torch.testing.assert_close(g, x.grad, rtol=1e-4, atol=1e-5)

    def test_cpu_autograd_never_enters_the_kernel_function(self, monkeypatch):
        called = []
        monkeypatch.setattr(port_fa.FlashAttention, 'apply',
                            lambda *a: called.append(a))
        q = torch.zeros((1, 8, 1, 16), requires_grad=True)
        port_fa.fused_attention(q, q, q).sum().backward()
        assert not called and q.grad is not None

    def test_needs_grad_follows_autograd_mode(self):
        q = torch.zeros(2, requires_grad=True)
        assert port_fa._needs_grad(q)
        with torch.no_grad():
            assert not port_fa._needs_grad(q)
        with torch.inference_mode():
            assert not port_fa._needs_grad(q)
        assert not port_fa._needs_grad(torch.zeros(2))

    def test_other_devices_raise_instead_of_falling_back(self):
        q = torch.empty((1, 8, 2, 64), device='meta')
        lse = torch.empty((1, 2, 8), device='meta')
        with pytest.raises(ValueError, match='runs on cuda'):
            port_fa.flash_attention_backward(q, q, q, q, lse, q)
        with pytest.raises(ValueError, match='runs on cuda'):
            port_fa.flash_attention_backward_dq(q, q, q, q, lse, lse)
        with pytest.raises(ValueError, match='runs on cuda'):
            port_fa.flash_attention_backward_dkv(q, q, q, q, lse, lse)

    def test_mismatched_residuals_raise(self):
        q = torch.zeros((1, 8, 2, 16))
        with pytest.raises(ValueError, match='lse must be'):
            port_fa.flash_attention_backward(q, q, q, q, torch.zeros(1, 8),
                                             q)
        with pytest.raises(ValueError, match='must have the shape'):
            port_fa.flash_attention_backward(q, q, q, q[:, :4],
                                             torch.zeros(1, 2, 8), q)

    def test_delta_is_the_f32_row_sum_of_do_times_out(self):
        out, do = (_torch(a, torch.bfloat16) for a in _arrays(2, t=8))
        delta = port_fa.attention_delta(out, do)
        assert delta.shape == (B, H, 8) and delta.dtype == torch.float32
        want = (out.float() * do.float()).sum(-1).transpose(1, 2)
        torch.testing.assert_close(delta, want)


class TestCardSideCheck:
    def test_backward_shapes_start_with_the_training_shape(self):
        assert kernel_check.BACKWARD_SHAPES[0] == (
            1, 8192, 16, 64, torch.bfloat16, True)
        for shape in kernel_check.BACKWARD_SHAPES:
            assert shape[3] in port_fa.KERNEL_HEAD_DIMS
            for bounds in (kernel_check.BACKWARD_ROW_TOL,
                           kernel_check.BACKWARD_HEAD_TOL,
                           kernel_check.AUTOGRAD_HEAD_TOL):
                assert shape[4] in bounds
        assert any(s[1] == 1 for s in kernel_check.BACKWARD_SHAPES)

    @pytest.mark.parametrize('shape', [(1, 40, 2, 16, torch.bfloat16, True),
                                       (2, 1, 2, 16, torch.bfloat16, True),
                                       (1, 33, 2, 32, torch.float32, False)])
    def test_plain_against_itself_reads_zero_and_passes(self, shape):
        """On the CPU the check's two sides are one plain version; T=1
        (dq = dk = 0 exactly) passes through the row floor."""
        r = kernel_check.backward_check(
            shape, torch.Generator().manual_seed(0), device='cpu')
        assert set(r['row_err'].values()) == {0.0}
        assert set(r['head_err'].values()) == {0.0}
        assert kernel_check.backward_ok(r, shape[4])

    def test_a_wrong_gradient_breaks_the_bounds(self):
        q, k, v, do = (_torch(a, torch.bfloat16)
                       for a in _arrays(t=96, d=32))
        out, lse = port_fa.reference_attention(q, k, v, with_lse=True)
        dq, dk, dv = port_fa.reference_attention_backward(q, k, v, out,
                                                          lse, do)
        bad = dv.clone()
        bad[:, 80:] *= 1.1          # the last keys' dv 10% off
        tol = kernel_check.BACKWARD_ROW_TOL[torch.bfloat16]
        assert kernel_check.row_relative_error(bad, dv) > 5 * tol
        assert kernel_check.head_relative_error(dv.float() * (1 + 2e-3),
                                                dv) > \
            kernel_check.BACKWARD_HEAD_TOL[torch.bfloat16]

    def test_head_error_floor(self):
        ref = torch.zeros((1, 4, 2, 8))
        out = torch.full_like(ref, 1e-6)
        assert kernel_check.head_relative_error(out, ref, least=1.0) < 1e-5
        assert kernel_check.head_relative_error(out, ref) > 1.0

    @pytest.mark.parametrize('fault', sorted(kernel_faults.BACKWARD_FAULTS))
    def test_planted_backward_fault_edits_the_shipped_source_once(self,
                                                                 fault):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.BACKWARD_KERNEL + '.cu')) as fh:
            source = fh.read()
        for old, new in kernel_faults.BACKWARD_FAULTS[fault]:
            assert source.count(old) == 1 and new != old

    def test_backward_kernel_source_names_what_it_replaces(self):
        with open(os.path.join(_build.CSRC_DIR,
                               'flash_attention_bwd.cu')) as fh:
            head = fh.read(5000)
        for name in ('_fa_bwd_dq_kernel', '_fa_bwd_dkv_kernel', 'sm_90a',
                     '989 TFLOP/s', '3.35 TB/s'):
            assert name in head
        assert 'flash_attention_bwd' in _build.kernel_names()

    def test_headers_key_every_kernel_build(self, tmp_path, monkeypatch):
        for name in ('a.cu', 'b.cu', 'common.cuh'):
            (tmp_path / name).write_text('// ' + name)
        monkeypatch.setattr(_build, 'CSRC_DIR', str(tmp_path))
        keys = (_build.source_key('a'), _build.source_key('b'))
        (tmp_path / 'common.cuh').write_text('// changed')
        assert _build.source_key('a') != keys[0]
        assert _build.source_key('b') != keys[1]


class TestDenseCe:
    @pytest.mark.parametrize('z_loss,smoothing', [(0.0, 0.0), (1e-4, 0.0),
                                                  (0.0, 0.1), (1e-4, 0.1)])
    def test_matches_jax(self, z_loss, smoothing):
        import jax.numpy as jnp
        from mlcomp_tpu.ops.fused_ce import softmax_ce_per_example
        rng = np.random.RandomState(0)
        logits = (rng.randn(64, 300) * 3).astype(np.float32)
        labels = rng.randint(-5, 310, 64).astype(np.int32)   # some clamp
        want = softmax_ce_per_example(
            jnp.asarray(logits), jnp.asarray(labels), impl='dense',
            z_loss=z_loss, label_smoothing=smoothing)
        got = port_ce.softmax_ce_per_example(
            torch.from_numpy(logits), torch.from_numpy(labels), impl='auto',
            z_loss=z_loss, label_smoothing=smoothing)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize('impl', ['pallas', 'cuda'])
    def test_kernel_impl_refuses_a_cpu_tensor(self, impl):
        """The kernel impls (a JAX config's ``pallas`` reads as ``cuda``)
        launch the CE kernels of ``csrc/fused_ce.cu`` and refuse a CPU
        tensor: there is no fallback to the plain version."""
        with pytest.raises(ValueError, match='needs CUDA tensors'):
            port_ce.softmax_ce_per_example(torch.zeros(2, 4),
                                           torch.zeros(2), impl=impl)

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match='unknown impl'):
            port_ce.softmax_ce_per_example(torch.zeros(2, 4),
                                           torch.zeros(2), impl='triton')


def _c_argtypes(source: str, name: str) -> list:
    """The ctypes types of the ``extern "C"`` function ``name``'s
    parameters, read from its declaration in ``source``."""
    import ctypes
    import re
    decl = re.search(r'\bint ' + name + r'\(([^)]*)\)', source).group(1)
    types = []
    for param in decl.split(','):
        words = param.split()[:-1]
        if param.strip().endswith('*') or any('*' in w for w in param.split()):
            types.append(ctypes.c_void_p)
        elif words[-2:] == ['long', 'long']:
            types.append(ctypes.c_longlong)
        elif words[-1] == 'float':
            types.append(ctypes.c_float)
        else:
            assert words[-1] == 'int', param
            types.append(ctypes.c_int)
    return types


class TestTmaOperands:
    """``_kernel_operand``: TMA reads a 16-bit operand through its
    strides only from a 16-byte aligned base with every stride a
    positive multiple of 16 bytes; anything else is copied first."""

    @pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
    def test_aligned_qkv_views_are_read_in_place(self, dtype):
        qkv = torch.zeros((2, 16, 3, 4, 64), dtype=dtype)
        assert qkv.data_ptr() % 16 == 0
        for x in qkv.unbind(2):       # rows 3·H·D elements apart
            assert x.stride() == (16 * 3 * 4 * 64, 3 * 4 * 64, 64, 1)
            assert port_fa._kernel_operand(x).data_ptr() == x.data_ptr()

    def test_misaligned_base_is_copied(self):
        flat = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)
        odd = flat[1:].view(2, 16, 4, 64)
        assert odd.data_ptr() % 16 != 0
        copied = port_fa._kernel_operand(odd)
        assert copied.data_ptr() != odd.data_ptr()
        assert copied.is_contiguous() and copied.data_ptr() % 16 == 0
        assert torch.equal(copied, odd)

    @pytest.mark.parametrize('width', [68, 72 + 1])
    def test_stride_off_16_bytes_is_copied(self, width):
        """A head stride of 68 elements (136 bytes) or 73 is no multiple
        of 16 bytes; 72 (144 bytes) is."""
        wide = torch.zeros((1, 8, 4, width), dtype=torch.bfloat16)
        x = wide[..., :64]
        copied = port_fa._kernel_operand(x)
        assert copied.data_ptr() != x.data_ptr() and copied.is_contiguous()
        ok = torch.zeros((1, 8, 4, 72), dtype=torch.bfloat16)[..., :64]
        assert port_fa._kernel_operand(ok).data_ptr() == ok.data_ptr()

    def test_broadcast_view_is_copied(self):
        row = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16)
        x = row.expand(2, 8, 4, 64)     # stride 0 over B and T
        copied = port_fa._kernel_operand(x)
        assert copied.is_contiguous() and copied.shape == x.shape

    def test_f32_takes_any_unit_stride_view(self):
        x = torch.zeros(2 * 8 * 4 * 33 + 1)[1:].view(2, 8, 4, 33)[..., :32]
        assert port_fa._kernel_operand(x).data_ptr() == x.data_ptr()


class TestCInterface:
    @pytest.mark.parametrize('kernel,name,counts', [
        ('flash_attention_bwd', 'flash_attention_bwd_dq', (7, 5, 12, 2)),
        ('flash_attention_bwd', 'flash_attention_bwd_dkv', (8, 5, 12, 1)),
        ('flash_attention_fwd', 'flash_attention_fwd', (5, 5, 12, 1))])
    def test_declared_argtypes_match_the_c_signature(self, kernel, name,
                                                     counts):
        """The wrappers' ``_declare`` calls give ctypes the C functions'
        parameter types (a pointer or stride passed as a 32-bit int would
        be cut). The TMA descriptors are encoded inside the C functions,
        so the interface takes no descriptor argument."""
        import inspect
        wrapper = inspect.getsource(port_fa)
        assert f'_declare(lib.{name}, {", ".join(map(str, counts))})' \
            in wrapper

        class Fn:
            argtypes = None
            restype = None

        fn = port_fa._declare(Fn(), *counts)
        with open(os.path.join(_build.CSRC_DIR, kernel + '.cu')) as fh:
            assert fn.argtypes == _c_argtypes(fh.read(), name)

    def test_backward_shapes_start_with_both_training_shapes(self):
        """The flagship's step (16 heads) and the wide LM's (32 heads),
        both B=1, T=8192, D=64, bf16, causal, are held and timed
        first."""
        assert kernel_check.BACKWARD_SHAPES[:2] == [
            (1, 8192, 16, 64, torch.bfloat16, True),
            (1, 8192, 32, 64, torch.bfloat16, True)]

    def test_backward_kernels_are_wgmma_with_tma(self):
        """The 16-bit backward runs on wgmma with TMA loads and a
        producer warpgroup; the mma.sync pair is gone."""
        with open(os.path.join(_build.CSRC_DIR,
                               'flash_attention_bwd.cu')) as fh:
            source = fh.read()
        for name in ('fa_bwd_dq_wgmma_kernel', 'fa_bwd_dkv_wgmma_kernel',
                     'Wgmma<T, D>::template rs<1>', 'Tl::load(',
                     'regs_dec<PRODUCER_REGS>', 'regs_inc<CONSUMER_REGS>',
                     'cuTensorMapEncodeTiled', '__grid_constant__'):
            assert name in source
        for gone in ('fa_bwd_dq_mma_kernel', 'fa_bwd_dkv_mma_kernel',
                     'Mma<T>::run', 'ldmatrix'):
            assert gone not in source

    def test_backward_faults_keep_their_classes_and_add_the_transpose(self):
        faults = set(kernel_faults.BACKWARD_FAULTS)
        assert len(faults) >= 6
        assert {'dkv_q_tile_skipped_in_last_512_keys',
                'dq_causal_mask_lets_next_key_in',
                'dkv_causal_mask_hides_the_diagonal', 'dq_ds_not_rounded',
                'dkv_lse_off_by_the_scale',
                'dv_transpose_bit_dropped'} <= faults


class TestKernelVariants:
    @pytest.mark.parametrize('variant', sorted(kernel_variants.VARIANTS))
    def test_variant_edits_the_shipped_source_once(self, variant):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.BACKWARD_KERNEL + '.cu')) as fh:
            source = fh.read()
        for old, new in kernel_variants.VARIANTS[variant][1]:
            assert source.count(old) == 1 and new != old

    @pytest.mark.parametrize('variant',
                             sorted(kernel_variants.FORWARD_VARIANTS))
    def test_forward_variant_edits_the_shipped_source_once(self, variant):
        with open(os.path.join(_build.CSRC_DIR,
                               kernel_faults.KERNEL + '.cu')) as fh:
            source = fh.read()
        for old, new in kernel_variants.FORWARD_VARIANTS[variant][1]:
            assert source.count(old) == 1 and new != old

    def test_forward_variants_cover_the_design_choices(self):
        """The schedule (overlap, turns), the tile and ring sizes and the
        consumers are each timed against the shipped forward, beside cost
        probes that give wrong output."""
        variants = kernel_variants.FORWARD_VARIANTS
        for name in ('fwd_overlap_only', 'fwd_pingpong_only', 'fwd_neither',
                     'fwd_block_n_64', 'fwd_two_stages', 'fwd_three_stages',
                     'fwd_two_consumers', 'fwd_no_branch_after_setmaxnreg'):
            assert variants[name][0]
        assert not variants['fwd_no_exp'][0]

    def test_advisories_name_the_forward_and_its_injected_waits(self):
        log = ("ptxas info    : (C7517) warpgroup.wait is injected in around "
               "line 10723 by compiler to allow use of registers defined by "
               "GMMA in function '_ZN55_GLOBAL__N__a2080d67_22_flash_attention"
               "_fwd_cu_2c13897919fa_fwd_wgmma_kernelI13__nv_bfloat16Li64EEEv"
               "NS_9TmaParamsE'")
        assert kernel_variants._advisories(log) == [
            'C7517 fa_fwd_wgmma_kernel<13__nv_bfloat16, 64>']

    def test_advisories_name_the_code_kernel_and_head_dim(self):
        log = ("ptxas info    : (C7515) Potential Performance Loss: wgmma."
               "mma_async instructions are serialized due to non wgmma "
               "instructions defining accumulator registers in the function "
               "'_ZN12_GLOBAL__N_123fa_bwd_dkv_wgmma_kernelI13__nv_bfloat16"
               "Li64EEEvNS_9TmaParamsE'\n"
               "    216 bytes stack frame, 636 bytes spill stores, 432 bytes "
               "spill loads\n"
               "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
               "loads")
        assert kernel_variants._advisories(log) == [
            'C7515 fa_bwd_dkv_wgmma_kernel<13__nv_bfloat16, 64>',
            '216 bytes stack frame, 636 bytes spill stores, 432 bytes '
            'spill loads']

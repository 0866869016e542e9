"""Causal flash attention forward: a hand-written CUDA kernel for Hopper.

Port of ``mlcomp_tpu/ops/flash_attention.py``. The TPU's Pallas kernel
``_fa_kernel`` becomes ``csrc/flash_attention_fwd.cu`` (its header says
what bounds it on the card and what the design does about that). This
slice ports the forward without the per-row logsumexp: serving applies
the model with ``train=False``, so neither ``lse`` nor the backward is on
its path.

- ``reference_attention``: the plain PyTorch version, the numerics the
  kernel must reproduce; the CPU path and the card-side check use it.
- ``flash_attention_forward``: the kernel's wrapper. It takes the plain
  version only for a tensor on the CPU. A CUDA tensor launches the kernel
  or raises; there is no fallback. ``flash_attention_forward.launches``
  counts the kernel's launches.
- ``fused_attention(impl=...)``: the entry point the transformer uses.
"""

import ctypes
from typing import Optional

import torch

from mlcomp_tpu_torch.ops import _build

NEG_INF = -1e30
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
#: the C interface's dtype codes (f32 runs the SIMT path, the 16-bit
#: types the tensor-core path)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: JAX export specs name the TPU's impls; the port maps them onto its own
_IMPL_ALIASES = {'pallas': 'cuda', 'interpret': 'auto'}
IMPLS = ('auto', 'dense', 'cuda')


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None, round_p: bool = False):
    """Dense softmax attention over [B, T, H, D]: scores and softmax in
    f32 (the products of bf16 pairs are exact in f32, as with the JAX
    version's ``preferred_element_type``), output cast to q's dtype.

    ``round_p`` follows the kernel (and the TPU kernel) one step
    further: ``exp(s - row max)`` is rounded to v's dtype before the PV
    product and the row sum is taken before rounding. The card-side
    check compares the kernel with this form, so its bound can be tight;
    the default is JAX's ``reference_attention``, which the CPU path
    matches."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    s.mul_(scale)
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, NEG_INF)
    if not round_p:
        p = torch.softmax(s, dim=-1)
        del s
        out = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
        return out.to(q.dtype)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    l = s.sum(dim=-1, keepdim=True).clamp_min_(1e-30)   # [B, H, T, 1]
    p = s.to(v.dtype)
    del s
    out = torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float())
    return out.div_(l.transpose(1, 2)).to(q.dtype)


def resolve_impl(name: str) -> str:
    """The port's attention impl for ``name``: ``auto``, ``dense`` or
    ``cuda``; a JAX export's ``pallas`` / ``interpret`` read as ``cuda``
    / ``auto``. Raises on anything else."""
    impl = _IMPL_ALIASES.get(name, name)
    if impl not in IMPLS:
        raise ValueError(
            f'unknown attn impl {name!r}: attn_impl must be one of {IMPLS} '
            f'(or pallas/interpret)')
    return impl


def check_attention_inputs(q, k, v):
    """Shapes and dtypes every path needs: [B, T, H, D], all alike."""
    if q.dim() != 4:
        raise ValueError(f'attention takes [B, T, H, D], got {tuple(q.shape)}')
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f'q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, '
            f'{tuple(v.shape)}')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f'q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}')
    if not (q.device == k.device == v.device):
        raise ValueError(
            f'q, k, v devices differ: {q.device}, {k.device}, {v.device}')


def check_kernel_inputs(q):
    """What the CUDA kernel takes beyond ``check_attention_inputs``."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f'flash_attention_fwd takes float32, bfloat16 or float16, '
            f'got {q.dtype}')
    b, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f'flash_attention_fwd takes head_dim in {KERNEL_HEAD_DIMS}, '
            f'got {d}')
    if b * h > 65535:
        raise ValueError(f'batch*heads {b * h} exceeds the grid limit 65535')


def _kernel_scale(q, scale: float):
    """(q, scale) with the scale made positive, as the kernel takes it:
    it finds the row max on unscaled scores. A negative scale moves its
    sign onto q (exact); a zero scale makes every score 0, which zero
    queries at scale 1 give exactly. Neither is on the model's path."""
    if scale > 0:
        return q, scale
    if scale < 0:
        return -q, -scale
    return torch.zeros_like(q), 1.0


def _kernel_operand(x):
    """x itself when the kernel can read it through its strides: unit
    head_dim stride and, for the 16-bit path's 16-byte copies, rows
    aligned to 16 bytes. Otherwise a contiguous copy."""
    if x.stride(-1) == 1:
        if x.dtype == torch.float32:
            return x
        if x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3]):
            return x
    return x.clone(memory_format=torch.contiguous_format)


def _c_function():
    """The C entry point with its argument types declared (ctypes would
    otherwise pass each pointer and stride as a 32-bit int)."""
    lib = _build.library('flash_attention_fwd')
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i] + [ll] * 12 + [
            ctypes.c_float, i, ptr]
        fn.restype = i
        lib.flash_attention_fwd_error_string.argtypes = [i]
        lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_attention_forward(q, k, v, causal: bool = True,
                            scale: Optional[float] = None):
    """Flash forward over [B, T, H, D] (any T; no lse). A CPU tensor takes
    the plain version; a CUDA tensor launches ``flash_attention_fwd``."""
    check_attention_inputs(q, k, v)
    if q.device.type == 'cpu':
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != 'cuda':
        raise ValueError(
            f'flash_attention_forward runs on cuda (or cpu: plain '
            f'version), got device {q.device}')
    b, t, h, d = q.shape
    check_kernel_inputs(q)
    q, scale = _kernel_scale(q, scale if scale is not None else d ** -0.5)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib, fn = _c_function()
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, h, d, _DTYPE_CODES[q.dtype], *strides,
                 float(scale), int(bool(causal)), stream)
    if err:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(
            f'flash_attention_fwd launch failed: CUDA error {err} ({msg}) '
            f'at B={b} T={t} H={h} D={d} {q.dtype}')
    flash_attention_forward.launches += 1
    return out


flash_attention_forward.launches = 0


def fused_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, impl: str = 'auto'):
    """Attention over [B, T, H, D] with implementation selection:

    - ``auto``: the kernel for a CUDA tensor, the plain version for a CPU
      tensor (never the plain version for a CUDA tensor)
    - ``cuda``: the kernel; CUDA tensors only
    - ``dense``: the plain version on any device
    - ``pallas`` / ``interpret`` (as JAX exports name them): ``cuda`` /
      ``auto``
    """
    impl = resolve_impl(impl)
    if impl == 'dense':
        check_attention_inputs(q, k, v)
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl == 'cuda' and q.device.type != 'cuda':
        raise ValueError(
            f"attn impl 'cuda' needs CUDA tensors, got device {q.device}")
    return flash_attention_forward(q, k, v, causal=causal, scale=scale)


__all__ = ['fused_attention', 'flash_attention_forward',
           'reference_attention', 'resolve_impl', 'NEG_INF',
           'KERNEL_HEAD_DIMS']

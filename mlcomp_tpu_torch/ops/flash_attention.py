"""Causal flash attention, forward and backward: hand-written CUDA
kernels for Hopper.

Port of ``mlcomp_tpu/ops/flash_attention.py``. The TPU's Pallas kernel
``_fa_kernel`` becomes ``csrc/flash_attention_fwd.cu``, its backward
kernels ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel`` become the two
kernels of ``csrc/flash_attention_bwd.cu`` (each file's header says what
bounds it on the card and what the design does about that).

- ``reference_attention`` / ``reference_attention_backward``: the plain
  PyTorch versions, the numerics the kernels must reproduce; the CPU path
  and the card-side checks use them.
- ``flash_attention_forward`` (optionally with the row logsumexp) and
  ``flash_attention_backward``: the kernels' wrappers. They take the
  plain versions only for tensors on the CPU. A CUDA tensor launches the
  kernels or raises; there is no fallback. ``flash_attention_forward
  .launches``, ``flash_attention_backward_dq.launches`` and
  ``flash_attention_backward_dkv.launches`` count the launches.
- ``fused_attention(impl=...)``: the entry point the transformer uses.
  On a CUDA tensor that needs a gradient it runs ``FlashAttention``, the
  port of the ``_flash_attention`` custom_vjp, which saves only
  (q, k, v, out, lse).
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


def _scores(q, k, causal: bool, scale: float):
    """f32 scaled scores [B, H, T, T] with the causal triangle at NEG_INF
    (the products of bf16 pairs are exact in f32, as with the JAX
    version's ``preferred_element_type``)."""
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    s.mul_(scale)
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, NEG_INF)
    return s


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None, round_p: bool = False,
                        with_lse: bool = False):
    """Dense softmax attention over [B, T, H, D]: scores and softmax in
    f32, output cast to q's dtype. ``with_lse`` also returns the row
    logsumexp of the scaled scores, [B, H, T] f32, as the JAX kernel's
    ``with_lse`` does.

    ``round_p`` follows the kernel (and the TPU kernel) one step
    further: ``exp(s - row max)`` is rounded to v's dtype before the PV
    product and the row sum is taken before rounding. The card-side
    check compares the kernel with this form, so its bound can be tight;
    the default is JAX's ``reference_attention``, which the CPU path
    matches."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1) if with_lse else None
    if not round_p:
        p = torch.softmax(s, dim=-1)
        del s
        out = torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)
        return (out, lse) if with_lse else out
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    l = s.sum(dim=-1, keepdim=True).clamp_min_(1e-30)   # [B, H, T, 1]
    p = s.to(v.dtype)
    del s
    out = torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float())
    out = out.div_(l.transpose(1, 2)).to(q.dtype)
    return (out, lse) if with_lse else out


def attention_delta(out, do):
    """delta = rowsum(dO * O) in f32, [B, H, T]: the dS correction term
    (computed outside the kernels, as the JAX package does)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _recompute_p_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P and dS [B, H, T, T] exactly as the backward kernels rebuild them:
    P = exp(scale * s - lse) (0 on the causal triangle), dS = P (dO Vᵀ -
    delta), both rounded to the input dtype for the gradient products."""
    p = _scores(q, k, causal, scale).sub_(lse[..., None]).exp_()
    ds = torch.einsum('bqhd,bkhd->bhqk', do.float(), v.float())
    ds.sub_(delta[..., None]).mul_(p)
    return p.to(q.dtype), ds.to(q.dtype)


def reference_attention_backward(q, k, v, out, lse, do, causal: bool = True,
                                 scale: Optional[float] = None):
    """(dq, dk, dv) of attention, the plain version of the kernels:
    products of rounded P and dS accumulated in f32, the scale applied
    after the dq and dk products, outputs in the inputs' dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds = _recompute_p_ds(q, k, v, do, lse.float(),
                            attention_delta(out, do), causal, scale)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.float(), do.float())
    del p
    ds = ds.float()
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k.float()).mul_(scale)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float()).mul_(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def resolve_impl(name: str) -> str:
    """The port's attention impl for ``name`` (``_build.resolve_impl``
    under the config key ``attn_impl``)."""
    return _build.resolve_impl(name, 'attn_impl')


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
    head_dim stride and, for the 16-bit types, TMA's rule (the forward
    and backward kernels load their tiles by TMA): the base 16-byte
    aligned and every other stride a positive multiple of 16 bytes (8
    elements). Otherwise a contiguous copy. The fused qkv's
    q, k and v views (rows 3·H·D elements apart) pass as they are."""
    if x.stride(-1) == 1:
        if x.dtype == torch.float32:
            return x
        if x.data_ptr() % 16 == 0 and all(
                s > 0 and s % 8 == 0 for s in x.stride()[:3]):
            return x
    return x.clone(memory_format=torch.contiguous_format)


def _declare(fn, n_ptr: int, n_int: int, n_stride: int, n_float: int):
    """Declare a C entry point's argument types once (ctypes would
    otherwise pass each pointer and stride as a 32-bit int): pointers,
    ints, strides, floats, then the causal flag and the stream."""
    if fn.argtypes is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * n_ptr + [i] * n_int + [ll] * n_stride
                       + [ctypes.c_float] * n_float + [i, ptr])
        fn.restype = i
    return fn


def _library(name: str):
    """The kernel library ``csrc/<name>.cu`` and its error-string
    function, declared."""
    lib = _build.library(name)
    err = getattr(lib, name + '_error_string')
    if err.argtypes is None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, err


def _check_launch(error_string, kernel: str, err: int, q):
    if err:
        b, t, h, d = q.shape
        raise RuntimeError(
            f'{kernel} launch failed: CUDA error {err} '
            f'({error_string(err).decode()}) at B={b} T={t} H={h} D={d} '
            f'{q.dtype}')


def _on_card(q, what: str):
    """Raise for anything but a CUDA tensor the kernels take."""
    if q.device.type != 'cuda':
        raise ValueError(
            f'{what} runs on cuda (or cpu: plain version), got device '
            f'{q.device}')
    check_kernel_inputs(q)


def _strides(*tensors) -> list:
    return [s for x in tensors for s in x.stride()[:3]]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_forward(q, k, v, causal: bool = True,
                            scale: Optional[float] = None,
                            with_lse: bool = False,
                            lse_out: Optional[torch.Tensor] = None):
    """Flash forward over [B, T, H, D] (any T). ``with_lse`` also returns
    the row logsumexp [B, H, T] f32 the backward needs, written into
    ``lse_out`` when given (a contiguous f32 tensor of that shape on q's
    device). A CPU tensor takes the plain version; a CUDA tensor
    launches ``flash_attention_fwd``."""
    check_attention_inputs(q, k, v)
    b, t, h, d = q.shape
    if lse_out is not None and not (
            with_lse and lse_out.shape == (b, h, t)
            and lse_out.dtype == torch.float32 and lse_out.is_contiguous()
            and lse_out.device == q.device):
        raise ValueError(
            f'lse_out must be a contiguous float32 [B, H, T] = '
            f'[{b}, {h}, {t}] tensor on {q.device}, with with_lse=True; '
            f'got {tuple(lse_out.shape)} {lse_out.dtype} on '
            f'{lse_out.device}')
    if q.device.type == 'cpu':
        result = reference_attention(q, k, v, causal=causal, scale=scale,
                                     with_lse=with_lse)
        if lse_out is None:
            return result
        return result[0], lse_out.copy_(result[1])
    _on_card(q, 'flash_attention_forward')
    q, scale = _kernel_scale(q, scale if scale is not None else d ** -0.5)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = None
    if with_lse:
        lse = lse_out if lse_out is not None else torch.empty(
            (b, h, t), dtype=torch.float32, device=q.device)
    lib, error_string = _library('flash_attention_fwd')
    fn = _declare(lib.flash_attention_fwd, 5, 5, 12, 1)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 b, t, h, d, _DTYPE_CODES[q.dtype],
                 *_strides(q, k, v, out), float(scale), int(bool(causal)),
                 _stream(q.device))
    _check_launch(error_string, 'flash_attention_fwd', err, q)
    flash_attention_forward.launches += 1
    return (out, lse) if with_lse else out


flash_attention_forward.launches = 0


def _backward_operands(q, k, v, do, lse, delta, scale: float):
    """What both backward kernels take: the operands as they read them,
    the positive score scale and the dq scale (the caller's own, which
    undoes ``_kernel_scale``'s moving a negative sign onto q)."""
    kq, kscale = _kernel_scale(q, scale)
    ops = [_kernel_operand(x) for x in (kq, k, v, do)]
    stats = [x.float().contiguous() for x in (lse, delta)]
    return ops, stats, kscale


def flash_attention_backward_dq(q, k, v, do, lse, delta, causal: bool = True,
                                scale: Optional[float] = None):
    """dq from the kernel ``flash_attention_bwd_dq`` (CUDA tensors)."""
    _on_card(q, 'flash_attention_backward_dq')
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    (kq, k, v, do), (lse, delta), kscale = _backward_operands(
        q, k, v, do, lse, delta, scale)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib, error_string = _library('flash_attention_bwd')
    fn = _declare(lib.flash_attention_bwd_dq, 7, 5, 12, 2)
    with torch.cuda.device(q.device):
        err = fn(kq.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 b, t, h, d, _DTYPE_CODES[q.dtype],
                 *_strides(kq, k, v, do), float(kscale), float(scale),
                 int(bool(causal)), _stream(q.device))
    _check_launch(error_string, 'flash_attention_bwd_dq', err, q)
    flash_attention_backward_dq.launches += 1
    return dq


flash_attention_backward_dq.launches = 0


def flash_attention_backward_dkv(q, k, v, do, lse, delta,
                                 causal: bool = True,
                                 scale: Optional[float] = None):
    """(dk, dv) from the kernel ``flash_attention_bwd_dkv`` (CUDA
    tensors)."""
    _on_card(q, 'flash_attention_backward_dkv')
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    (kq, k, v, do), (lse, delta), kscale = _backward_operands(
        q, k, v, do, lse, delta, scale)
    dk = torch.empty((b, t, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=v.dtype, device=q.device)
    lib, error_string = _library('flash_attention_bwd')
    fn = _declare(lib.flash_attention_bwd_dkv, 8, 5, 12, 1)
    with torch.cuda.device(q.device):
        err = fn(kq.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, t, h, d, _DTYPE_CODES[q.dtype],
                 *_strides(kq, k, v, do), float(kscale), int(bool(causal)),
                 _stream(q.device))
    _check_launch(error_string, 'flash_attention_bwd_dkv', err, q)
    flash_attention_backward_dkv.launches += 1
    return dk, dv


flash_attention_backward_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, do, causal: bool = True,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of attention from the forward's residuals: out and
    lse [B, H, T]. A CPU tensor takes the plain version; a CUDA tensor
    launches both backward kernels."""
    check_attention_inputs(q, k, v)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f'out {tuple(out.shape)} and do {tuple(do.shape)} must have '
            f'the shape of q {tuple(q.shape)}')
    b, t, h, _ = q.shape
    if lse.shape != (b, h, t):
        raise ValueError(f'lse must be [B, H, T] = {(b, h, t)}, got '
                         f'{tuple(lse.shape)}')
    if q.device.type == 'cpu':
        return reference_attention_backward(q, k, v, out, lse, do,
                                            causal=causal, scale=scale)
    _on_card(q, 'flash_attention_backward')
    do = do.to(q.dtype)
    delta = attention_delta(out, do)
    dq = flash_attention_backward_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_backward_dkv(q, k, v, do, lse, delta, causal,
                                          scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The ``_flash_attention`` custom_vjp: the forward kernel with lse,
    residuals (q, k, v, out, lse) only, and the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def fused_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, impl: str = 'auto'):
    """Attention over [B, T, H, D] with implementation selection:

    - ``auto``: the kernels for a CUDA tensor, the plain version (with
      torch autograd) for a CPU tensor — never the plain version for a
      CUDA tensor
    - ``cuda``: the kernels; CUDA tensors only
    - ``dense``: the plain version on any device
    - ``pallas`` / ``interpret`` (as JAX exports name them): ``cuda`` /
      ``auto``

    On a CUDA tensor the forward kernel runs alone (no lse) under
    ``no_grad``/``inference_mode``; when autograd needs a gradient it
    runs ``FlashAttention`` (forward with lse, backward kernels).
    """
    impl = resolve_impl(impl)
    if impl == 'dense':
        check_attention_inputs(q, k, v)
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl == 'cuda' and q.device.type != 'cuda':
        raise ValueError(
            f"attn impl 'cuda' needs CUDA tensors, got device {q.device}")
    if q.device.type == 'cuda' and _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_forward(q, k, v, causal=causal, scale=scale)


__all__ = ['fused_attention', 'flash_attention_forward',
           'flash_attention_backward', 'flash_attention_backward_dq',
           'flash_attention_backward_dkv', 'FlashAttention',
           'reference_attention', 'reference_attention_backward',
           'attention_delta', 'resolve_impl', 'NEG_INF', 'KERNEL_HEAD_DIMS']

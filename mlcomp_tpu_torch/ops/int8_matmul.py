"""Weight-only int8 matmul for the serving path: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Port of the serving half of ``mlcomp_tpu/ops/int8_matmul.py``. The TPU's
Pallas kernel ``_kernel`` (launched by ``_pallas_int8_matmul``) becomes
``csrc/int8_matmul.cu`` (its header says what bounds it on the card and
what the design does about that)::

    y[M, N] = (x[M, K] @ dequant(w_qt[N, K]).T) * scale[N]      (f32)

- ``quantize_int8``: symmetric per-output-channel quantization of a
  [K, N] weight (absmax / 127, 1 where a column is all zeros, round half
  to even, clip to ±127), returning the TRANSPOSED int8 [N, K] and the
  f32 scale [N] — bit for bit the JAX package's.
- ``reference_int8_matmul``: the plain version. x cast to bf16 and the
  int8 values (exact in bf16) multiplied in f32, the scale applied once
  to the f32 [M, N] product (post-scaling).
- ``int8_matmul(impl=...)``: ``auto`` launches the kernel for a CUDA
  tensor and takes the plain version for a CPU tensor; ``cuda`` the
  kernel (a CPU tensor raises); ``dense`` the plain version anywhere; a
  JAX caller's ``pallas`` / ``interpret`` read as ``cuda`` / ``auto``.
  There is no fallback from the kernel. The JAX package's ``auto →
  dense`` was a TPU measurement and does not carry over, nor does its
  tile gate (M % 8, K % 128, N % 128): the kernel takes any M, N, K ≥ 1
  (TMA's rule, K a multiple of 16 and aligned bases, is met here by
  zero-padding K). ``bias`` and ``out_dtype`` fuse ``Int8Dense``'s
  epilogue into the launch. ``int8_matmul.launches`` counts the calls
  that launched it.
- ``Int8Dense``: the serving predictor's stand-in for a ``Dense`` module
  (``train/export.py`` swaps them in): the int8 weight, the scale and the
  bias as buffers; ``int8_matmul`` with the bias added in f32 and the
  result cast to the module's dtype — ``_quantized_interceptor``'s
  numerics (``reference_epilogue``), in one launch.

The training half (``_quantize_rows``, ``reference_int8_train_matmul``,
``Int8TrainMatmul`` and ``int8_train_matmul``: the dynamic int8 product
of ``matmul_precision: int8`` training) follows under "training" below.
"""

import ctypes
from typing import Optional

import torch
from torch import nn

from mlcomp_tpu_torch.ops import _build

def quantize_int8(w):
    """Symmetric per-output-channel quantization of a [K, N] weight.
    Returns (w_qt int8 [N, K] — TRANSPOSED — and scale f32 [N]) with
    ``dequant = (w_qt * scale[:, None]).T``, on w's device."""
    w = torch.as_tensor(w).float()
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale), -127, 127)
    return w_q.t().to(torch.int8).contiguous(), scale


def reference_int8_matmul(x, w_qt, scale, compute_dtype=torch.bfloat16):
    """The plain version: x cast to ``compute_dtype`` (bf16) and the int8
    weight (exact in bf16) multiplied in f32 — every product exact, the
    sum in f32 — then the per-channel scale applied once."""
    y = x.to(compute_dtype).float() @ w_qt.to(compute_dtype).float().t()
    return y * scale.float()[None, :]


def check_int8_inputs(x, w_qt, scale):
    if x.dim() != 2 or w_qt.dim() != 2 or x.shape[1] != w_qt.shape[1] \
            or tuple(scale.shape) != (w_qt.shape[0],):
        raise ValueError(
            f'shape mismatch: x {tuple(x.shape)}, w_qt '
            f'{tuple(w_qt.shape)} (transposed [N, K] from quantize_int8), '
            f'scale {tuple(scale.shape)}')
    if not (x.device == w_qt.device == scale.device):
        raise ValueError(f'x, w_qt, scale devices differ: {x.device}, '
                         f'{w_qt.device}, {scale.device}')


def _library():
    lib = _build.library('int8_matmul')
    fn = lib.int8_matmul
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # x, w, scale, bias, out (pointers); out type; partial; M, N, K;
        # stream
        fn.argtypes = [ptr] * 5 + [i, ptr] + [i] * 3 + [ptr]
        fn.restype = i
        ws = lib.int8_matmul_workspace
        ws.argtypes = [i, i, i]
        ws.restype = ctypes.c_longlong
        err = lib.int8_matmul_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


#: the kernel's output types (its C interface's codes)
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: TMA's rule for the kernel's operands: rows of whole 16-byte chunks
#: (K a multiple of 16 for the int8 weight) and 16-byte aligned bases
TMA_K = 16


def tma_operand(t, k_pad: int):
    """``t`` [rows, K] as the kernel's TMA loads take it: contiguous, its
    base 16-byte aligned, K zero-padded to ``k_pad`` (zeros add nothing
    to the sums). ``t`` itself where it already is."""
    if t.shape[-1] != k_pad:
        return torch.nn.functional.pad(t, (0, k_pad - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w_qt, scale, out, bias=None, out_dtype=torch.float32):
    """The kernel on CUDA tensors: ``out`` (``out_dtype`` [M, N],
    contiguous) or a new one."""
    m, k = x.shape
    n = w_qt.shape[0]
    if w_qt.dtype != torch.int8 or not w_qt.is_contiguous():
        raise ValueError(f'int8_matmul takes a contiguous int8 w_qt, got '
                         f'{w_qt.dtype} with strides {w_qt.stride()}')
    k_pad = -(-k // TMA_K) * TMA_K
    x = tma_operand(x.to(torch.bfloat16), k_pad)
    w_qt = tma_operand(w_qt, k_pad)
    scale = scale.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    elif out.shape != (m, n) or out.dtype != out_dtype \
            or not out.is_contiguous() or out.device != x.device:
        raise ValueError(f'out must be a contiguous {out_dtype} [{m}, {n}] '
                         f'on {x.device}')
    lib = _library()
    with torch.cuda.device(x.device):
        # the scratch is sized from this device's plan
        need = lib.int8_matmul_workspace(m, n, k_pad)
        partial = torch.empty(need, dtype=torch.float32, device=x.device) \
            if need else None
        err = lib.int8_matmul(
            x.data_ptr(), w_qt.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            OUT_DTYPES[out_dtype],
            None if partial is None else partial.data_ptr(), m, n, k_pad,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f'int8_matmul launch failed: CUDA error {err} '
            f'({lib.int8_matmul_error_string(err).decode()}) at M={m} '
            f'K={k} N={n}')
    int8_matmul.launches += 1
    return out


def reference_epilogue(y, bias=None, out_dtype=torch.float32):
    """``Int8Dense``'s epilogue on the f32 product: the bias added in f32,
    then the cast (``_quantized_interceptor``'s numerics)."""
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul(x, w_qt, scale, impl: str = 'auto',
                out: Optional[torch.Tensor] = None, bias=None,
                out_dtype=None):
    """``x [M, K] @ dequant(w_qt [N, K]).T -> f32 [M, N]``.

    - ``auto``: the kernel for a CUDA tensor, the plain version for a CPU
      tensor — never the plain version for a CUDA tensor
    - ``cuda``: the kernel; CUDA tensors only
    - ``dense``: the plain version on any device
    - ``pallas`` / ``interpret``: ``cuda`` / ``auto``

    ``bias`` (f32 [N]) and ``out_dtype`` (f32, bf16 or fp16) fuse
    ``Int8Dense``'s epilogue: ``((y * scale) + bias)`` in f32, cast to
    ``out_dtype`` — bit for bit the product followed by
    ``reference_epilogue``. Without them the result is the JAX
    signature's f32 product. ``out`` (the kernel only): a contiguous
    ``out_dtype`` [M, N] to write into.
    """
    check_int8_inputs(x, w_qt, scale)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'out_dtype must be one of '
                         f'{sorted(map(str, OUT_DTYPES))}, got {out_dtype}')
    if bias is not None and (tuple(bias.shape) != (w_qt.shape[0],)
                             or bias.device != x.device):
        raise ValueError(f'bias must be [{w_qt.shape[0]}] on {x.device}, '
                         f'got {tuple(bias.shape)} on {bias.device}')
    impl = _build.resolve_impl(impl, 'impl')
    if impl == 'cuda' and x.device.type != 'cuda':
        raise ValueError(
            f"int8_matmul impl 'cuda' needs CUDA tensors, got device "
            f'{x.device}')
    if impl == 'dense' or x.device.type == 'cpu':
        if out is not None:
            raise ValueError('out= is the kernel\'s; the plain version '
                             'returns a new tensor')
        return reference_epilogue(reference_int8_matmul(x, w_qt, scale),
                                  bias, out_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'int8_matmul runs on cuda (or cpu: plain '
                         f'version), got device {x.device}')
    return _launch(x, w_qt, scale, out, bias, out_dtype)


int8_matmul.launches = 0


class Int8Dense(nn.Module):
    """A ``Dense`` with its weight quantized once: buffers ``w_qt`` (int8
    [out, in]), ``scale`` (f32 [out]) and ``bias`` (or None). Forward:
    ``int8_matmul`` over the flattened leading dims with the bias added in
    f32 and the result cast to ``dtype`` (left f32 where it is None) —
    ``_quantized_interceptor``'s numerics, in the kernel's one launch
    where ``dtype`` is one of its output types."""

    #: ``int8_matmul``'s impl; ``'dense'`` runs the plain product on any
    #: device (the card-side comparison sets it)
    impl = 'auto'

    def __init__(self, w_qt, scale, bias=None, dtype=None):
        super().__init__()
        self.register_buffer('w_qt', w_qt)
        self.register_buffer('scale', scale)
        self.register_buffer('bias', bias)
        self.dtype = dtype

    @classmethod
    def from_dense(cls, module) -> 'Int8Dense':
        """Quantize ``module``'s [out, in] weight where it lies (the JAX
        kernel is its transpose) and keep its bias and dtype."""
        with torch.no_grad():
            w_qt, scale = quantize_int8(module.weight.detach().t())
        bias = getattr(module, 'bias', None)
        return cls(w_qt, scale, None if bias is None else bias.detach(),
                   getattr(module, 'dtype', None))

    def forward(self, x):
        dtype = self.dtype or torch.float32
        fused = dtype in OUT_DTYPES
        y = int8_matmul(x.reshape(-1, x.shape[-1]), self.w_qt, self.scale,
                        impl=self.impl, bias=self.bias if fused else None,
                        out_dtype=dtype if fused else None)
        y = y.reshape(*x.shape[:-1], self.w_qt.shape[0])
        return y if fused else reference_epilogue(y, self.bias, dtype)


# --------------------------------------------------------------- training
# Port of ``int8_train_matmul`` (``mlcomp_tpu/ops/int8_matmul.py``
# :186-274), a jnp custom_vjp there and no Pallas kernel: both operands
# of ``x [M, K] @ w`` are quantized to int8 dynamically, every step, per
# channel — x per ROW, the weight per OUTPUT channel (a column of JAX's
# [K, N] kernel, a row of the port's [N, K] weight) — the int8 values are
# multiplied exactly with int32/f32 sums and both scales are applied once
# to the f32 [M, N] product. Gradients are straight-through on the
# quantizer and contract the SAME int8 residuals the forward saved:
#
#     dx = (dy * sw) @ qw        dw = (dy * sx)^T @ qx      (port layout)
#
# so what is held for the backward is int8 plus f32 scales, never x or w.


def _quantize_rows(x):
    """Per-ROW symmetric int8 quantization of [M, K] (the JAX package's
    ``_quantize_rows``, bit for bit): the values upcast to f32, scale
    ``absmax / 127`` per row (1 for an all-zero row), round half to even,
    clip to ±127. Returns (int8 [M, K], f32 scale [M])."""
    x = x.float()
    absmax = x.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int_product(qx, qw):
    """``qx [M, K] @ qw [N, K]^T`` of int8 values, f32 [M, N].

    On the card ``torch._int_mm`` (the int8 tensor cores, exact int32
    sums) where its shape rule holds — M > 16, K and N multiples of 8,
    decided on the shapes before the call; qw is passed as the
    column-major view ``qw.t()`` of the row-major weight, the layout the
    int8 GEMM takes without a copy. Elsewhere (the CPU, or shapes outside
    that rule) the exact int8 values in f32, f32 sums, as the JAX
    package's ``_accum_dot`` computes them."""
    m, k = qx.shape
    n = qw.shape[0]
    if qx.device.type == 'cuda' and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(qx, qw.t()).float()
    return qx.float() @ qw.float().t()


def reference_int8_train_matmul(x, w, compute_dtype=torch.bfloat16):
    """The STE oracle: ``dequant(q(x)) @ dequant(q(w))^T`` with each
    quantizer straight-through (``v + (dq(q(v)) - v).detach()``), so
    autograd of this function gives the gradients ``Int8TrainMatmul``
    must emit. ``w`` is the port's [N, K] weight; f32 [M, N] out."""
    def ste(v):
        v32 = v.float()
        absmax = v32.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones_like(absmax))
        dq = torch.clamp(torch.round(v32 / scale), -127, 127) * scale
        return v32 + (dq - v32).detach()

    return (ste(x).to(compute_dtype).float()
            @ ste(w).to(compute_dtype).float().t())


def _accum_product(a, b, dtype):
    """``a @ b`` of ``compute_dtype`` operands with f32 sums, returned in
    ``dtype`` (JAX's ``_accum_dot`` with ``preferred_element_type=f32``,
    then the cast to the gradient's dtype). An f32 result of 16-bit
    operands is ``torch.mm(..., out_dtype=float32)`` on the card and the
    exact operand values in f32 on the CPU (where that form is not
    implemented); any other result is the product in the operands' dtype
    (f32 sums, rounded once), cast."""
    if dtype == torch.float32 and a.dtype != torch.float32:
        if a.device.type == 'cuda':
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()
    return torch.matmul(a, b).to(dtype)


class Int8TrainMatmul(torch.autograd.Function):
    """``x [M, K] @ w [N, K]^T -> f32 [M, N]`` with both operands
    quantized to int8 per channel and straight-through gradients (the
    JAX package's ``int8_train_matmul`` custom_vjp). Saves only the int8
    residuals and their f32 scales (qx, sx, qw, sw). The backward folds
    each scale into dy so that the int8 operand is cast exactly to
    ``compute_dtype`` and contracted there with f32 sums
    (``_accum_product``: bf16 operands on the card, as JAX's
    ``_accum_dot``; the CPU tests pass f32); dx comes back in x's dtype,
    dw in w's, each rounded once from the f32 sums."""

    @staticmethod
    def forward(ctx, x, w, compute_dtype=torch.bfloat16):
        qx, sx = _quantize_rows(x)
        qw, sw = _quantize_rows(w)
        y = int_product(qx, qw) * sx[:, None] * sw[None, :]
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.meta = (x.dtype, w.dtype, compute_dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        qx, sx, qw, sw = ctx.saved_tensors
        x_dtype, w_dtype, cd = ctx.meta
        dy = dy.float()
        dx = _accum_product((dy * sw[None, :]).to(cd), qw.to(cd), x_dtype)
        dw = _accum_product((dy * sx[:, None]).to(cd).t(), qx.to(cd),
                           w_dtype)
        return dx, dw, None


def int8_train_matmul(x, w, compute_dtype=torch.bfloat16):
    """``Int8TrainMatmul`` on x [M, K] and the port's weight w [N, K]."""
    return Int8TrainMatmul.apply(x, w, compute_dtype)


__all__ = ['quantize_int8', 'int8_matmul', 'reference_int8_matmul',
           'reference_epilogue', 'Int8Dense', 'check_int8_inputs',
           'int8_train_matmul', 'Int8TrainMatmul',
           'reference_int8_train_matmul', 'int_product', 'OUT_DTYPES']

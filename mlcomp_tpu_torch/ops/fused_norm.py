"""Fused batch-norm(+ReLU): a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Port of ``mlcomp_tpu/ops/fused_norm.py``. The TPU's Pallas kernel
``_norm_kernel`` (launched by ``_pallas_norm_act``) becomes
``csrc/fused_norm.cu`` (its header says what bounds it on the card and
what the design does about that).

- ``reference_norm_act``: the plain version and the eval path — batch
  norm over the rows of ``[R, C]`` with statistics in f32 (E[x²] −
  mean², clipped at 0, the biased variance), or with given ``stats``.
- ``norm_act_forward``: the kernel's wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises — there is
  no fallback. ``norm_act_forward.launches`` counts the calls that
  launched it (one per norm site: the kernel runs as three launches,
  statistics, finalize and normalize).
- ``FusedNormAct``: the ``custom_vjp`` as an ``autograd.Function``. Its
  backward is ``_fused_bwd``'s dense batch-norm backward through the
  batch statistics in plain torch ops, the ReLU mask recomputed (no
  kernel, as in the JAX package); mean and var carry no gradient.
- ``fused_norm_act(impl=...)``: the entry point ``models/resnet.py``
  uses. ``auto`` is the kernel for CUDA tensors and the plain version
  for CPU tensors; ``cuda`` the kernel (a CPU tensor raises); ``dense``
  the plain version anywhere. A JAX export's ``pallas`` / ``interpret``
  read as ``cuda`` / ``auto``.

The TPU lane gate (``_use_pallas``: C a multiple of 128 or a divisor of
it, R a multiple of 8) is not carried over: the CUDA kernel takes any
R ≥ 1 and C ≥ 1.
"""

import ctypes
from typing import Optional, Tuple

import torch

from mlcomp_tpu_torch.ops import _build

#: the C interface's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def resolve_norm_impl(name: str) -> str:
    """The port's norm impl for ``name`` (``_build.resolve_impl`` under
    the model key ``norm_impl``)."""
    return _build.resolve_impl(name, 'norm_impl')


def reference_norm_act(x2d, gamma, beta, eps: float = 1e-5, act: bool = True,
                       stats: Optional[Tuple] = None):
    """Batch norm over the rows of ``x2d`` [R, C] (+ ReLU when ``act``):
    ``(y, mean, var)``, y in x's dtype, mean and var f32 [C] (f64 for
    an f64 x, which the card-side check uses as its exact reference).
    ``stats`` = (mean, var) normalises with those instead (the eval
    path)."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    x32 = x2d.to(acc)
    if stats is None:
        mean = x32.mean(dim=0)
        var = ((x32 * x32).mean(dim=0) - mean * mean).clamp_min(0.0)
    else:
        mean, var = (s.to(acc) for s in stats)
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean) * (inv * gamma.to(acc)) + beta.to(acc)
    if act:
        y = y.clamp_min(0.0)
    return y.to(x2d.dtype), mean, var


def check_norm_inputs(x2d, gamma, beta):
    if x2d.dim() != 2 or x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError(f'fused norm takes x as [R, C] with R, C >= 1, got '
                         f'{tuple(x2d.shape)}')
    c = x2d.shape[1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f'gamma {tuple(gamma.shape)} and beta '
                         f'{tuple(beta.shape)} must be [{c}]')
    if not (x2d.device == gamma.device == beta.device):
        raise ValueError(f'x, gamma, beta devices differ: {x2d.device}, '
                         f'{gamma.device}, {beta.device}')


def _library():
    lib = _build.library('fused_norm')
    fn = lib.fused_norm_act
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # x, gamma, beta, y, mean, var, partial (pointers); R, C, dtype;
        # eps; act; stream
        fn.argtypes = [ptr] * 7 + [i] * 3 + [ctypes.c_float, i, ptr]
        fn.restype = i
        lib.fused_norm_scratch_rows.argtypes = [i, i]
        lib.fused_norm_scratch_rows.restype = i
        err = lib.fused_norm_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def norm_act_forward(x2d, gamma, beta, eps: float = 1e-5, act: bool = True):
    """Train-mode batch norm (+ ReLU) over [R, C]: ``(y, mean, var)``. A
    CPU tensor takes the plain version; a CUDA tensor launches the
    ``fused_norm`` kernel."""
    check_norm_inputs(x2d, gamma, beta)
    if x2d.device.type == 'cpu':
        return reference_norm_act(x2d, gamma, beta, eps=eps, act=act)
    if x2d.device.type != 'cuda':
        raise ValueError(f'fused norm runs on cuda (or cpu: plain version), '
                         f'got device {x2d.device}')
    if x2d.dtype not in _DTYPE_CODES:
        raise ValueError(f'fused_norm takes float32, bfloat16 or float16, '
                         f'got {x2d.dtype}')
    if not x2d.is_contiguous():
        # the model hands over channels_last activations, whose [R, C]
        # rows are a view; a copy here would add a pass over x
        raise ValueError('fused_norm takes a contiguous [R, C] x (rows of a '
                         'channels_last activation)')
    r, c = x2d.shape
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    y = torch.empty_like(x2d)
    mean = torch.empty(c, dtype=torch.float32, device=x2d.device)
    var = torch.empty(c, dtype=torch.float32, device=x2d.device)
    lib = _library()
    # scratch: the row blocks' sums of x - k and (x - k)², then the
    # per-channel shift k; the kernel chooses the row blocks
    partial = torch.empty((lib.fused_norm_scratch_rows(r, c), c),
                          dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = lib.fused_norm_act(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), partial.data_ptr(), r, c,
            _DTYPE_CODES[x2d.dtype], float(eps), int(bool(act)),
            torch.cuda.current_stream(x2d.device).cuda_stream)
    if err:
        raise RuntimeError(
            f'fused_norm launch failed: CUDA error {err} '
            f'({lib.fused_norm_error_string(err).decode()}) at R={r} C={c} '
            f'{x2d.dtype}')
    norm_act_forward.launches += 1
    return y, mean, var


norm_act_forward.launches = 0


def norm_act_backward(x2d, gamma, beta, mean, var, dy, eps: float,
                      act: bool):
    """(dx, dgamma, dbeta) of train-mode batch norm through the batch
    statistics (``_fused_bwd``), in f32, the ReLU mask recomputed from
    (x, stats, gamma, beta).

    ``_fused_bwd``'s dx = inv/R·(R·dxhat − Σdxhat − xhat·Σ(dxhat·xhat))
    with dxhat = dy·gamma is written as inv·gamma·(dy − dbeta/R −
    xhat·dgamma/R), the same value, so that each [R, C] pass reads and
    writes as little as it can (five full passes instead of about
    twelve)."""
    r = x2d.shape[0]
    g32 = gamma.float()
    inv = torch.rsqrt(var + eps)
    xhat = torch.addcmul(-mean * inv, x2d, inv)          # f32 [R, C]
    if act:
        dy = torch.where(torch.addcmul(beta.float(), xhat, g32) > 0, dy, 0)
    dbeta = dy.sum(dim=0, dtype=torch.float32)
    dgamma = (dy * xhat).sum(dim=0)
    dx = xhat.mul_(-dgamma / r).add_(dy).sub_(dbeta / r).mul_(inv * g32)
    return dx.to(x2d.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


class FusedNormAct(torch.autograd.Function):
    """``fused_norm_act``'s custom_vjp: the forward (kernel on CUDA, plain
    version on the CPU) saves (x, gamma, beta, mean, var); the backward
    is the dense batch-norm backward."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps: float, act: bool, impl: str):
        if impl == 'dense':
            y, mean, var = reference_norm_act(x2d, gamma, beta, eps=eps,
                                              act=act)
        else:
            y, mean, var = norm_act_forward(x2d, gamma, beta, eps=eps,
                                            act=act)
        ctx.save_for_backward(x2d, gamma, beta, mean, var)
        ctx.eps, ctx.act = eps, act
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = norm_act_backward(x2d, gamma, beta, mean, var,
                                              dy, ctx.eps, ctx.act)
        return dx, dgamma, dbeta, None, None, None


def fused_norm_act(x2d, gamma, beta, eps: float = 1e-5, act: bool = True,
                   impl: str = 'auto'):
    """Train-mode batch norm over the rows of ``x2d`` [R, C] with the
    ReLU folded in: ``(y, mean, var)``, differentiable in (x, gamma,
    beta) through the batch statistics.

    - ``auto``: the kernel for a CUDA tensor, the plain version for a
      CPU tensor — never the plain version for a CUDA tensor
    - ``cuda``: the kernel; CUDA tensors only
    - ``dense``: the plain version on any device
    - ``pallas`` / ``interpret`` (as JAX exports name them): ``cuda`` /
      ``auto``
    """
    impl = resolve_norm_impl(impl)
    check_norm_inputs(x2d, gamma, beta)
    if impl == 'cuda' and x2d.device.type != 'cuda':
        raise ValueError(
            f"norm impl 'cuda' needs CUDA tensors, got device {x2d.device}")
    return FusedNormAct.apply(x2d, gamma, beta, float(eps), bool(act), impl)


__all__ = ['fused_norm_act', 'norm_act_forward', 'norm_act_backward',
           'reference_norm_act', 'FusedNormAct', 'resolve_norm_impl',
           'check_norm_inputs']

"""Softmax cross-entropy per example: the hand-written CUDA kernels for
Hopper and their plain PyTorch versions — port of
``mlcomp_tpu/ops/fused_ce.py``.

The TPU's Pallas kernels ``_ce_fwd_kernel`` / ``_ce_bwd_kernel``
(launched by ``_pallas_ce_fwd`` / ``_pallas_ce_bwd``) become
``csrc/fused_ce.cu`` (its header says what bounds them on the card and
what the design does about that):

- ``reference_ce``: the dense formulation (``impl='dense'``), f32
  losses, differentiated by autograd;
- ``reference_ce_fwd`` / ``reference_ce_bwd``: the plain versions of the
  two kernels — per-row (loss, lse), and the logits' gradient from the
  saved lse, ``dx = (p·(1 + 2z·lse) − (1−ε)·onehot − ε/V)·g`` in the
  logits' dtype. The CPU path and the tests use them;
- ``ce_forward`` / ``ce_backward``: the kernels' wrappers. A CPU tensor
  takes the plain version, a CUDA tensor launches the kernel or raises:
  there is no fallback. Each counts its launches (``.launches``), and
  ``softmax_ce_per_example.launches`` counts both;
- ``FusedCE``: the ``_fused_ce`` custom_vjp as an ``autograd.Function``;
  it saves only (logits, labels, lse), and the labels get no gradient;
- ``softmax_ce_per_example(impl=...)``: ``auto`` is ``FusedCE`` — the
  kernels for a CUDA tensor, their plain versions for a CPU tensor;
  ``cuda`` the kernels (a CPU tensor raises); ``dense`` the dense
  formulation anywhere; a JAX config's ``pallas`` / ``interpret`` read
  as ``cuda`` / ``auto``.

The JAX package's ``auto → dense`` was a TPU measurement and does not
carry over, nor does its tile gate (N % 8, V % 128): the kernels take
any N ≥ 1 and V ≥ 1, and a row stride (the LM's ``logits[:, :-1]`` at
batch 1 is read in place). Labels outside [0, V) are clamped to the
nearest valid index before dispatch, as in the JAX package; there is no
ignore-index convention.
"""

import ctypes
from typing import Optional, Tuple

import torch

from mlcomp_tpu_torch.ops import _build

#: the C interface's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _acc(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for an f64 input (the card-side check's exact
    reference)."""
    return torch.promote_types(x.dtype, torch.float32)


def reference_ce_fwd(logits, labels, z_loss: float = 0.0,
                     label_smoothing: float = 0.0):
    """The forward kernel's plain version: ``(loss, lse)``, f32 [N] each
    (f64 for an f64 input), labels taken as given. ``z_loss`` adds
    ``z * lse^2``; ``label_smoothing`` gives ``lse - (1-eps)*picked -
    (eps/V)*sum(logits)``."""
    x = logits.to(_acc(logits))
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    picked = x.gather(-1, labels[:, None].long())[:, 0]
    if label_smoothing:
        eps = float(label_smoothing)
        loss = lse - (1.0 - eps) * picked - (eps / v) * x.sum(dim=-1)
    else:
        loss = lse - picked
    if z_loss:
        loss = loss + float(z_loss) * lse * lse
    return loss, lse


def reference_ce(logits, labels, z_loss: float = 0.0,
                 label_smoothing: float = 0.0):
    """The dense formulation: exact per-example CE in f32 over [N, V]
    logits and [N] labels, differentiated by autograd."""
    return reference_ce_fwd(logits, labels, z_loss, label_smoothing)[0]


def reference_ce_bwd(logits, labels, lse, g, z_loss: float = 0.0,
                     label_smoothing: float = 0.0):
    """The backward kernel's plain version: ``dx = (p·(1 + 2z·lse) −
    ((1−ε)·onehot + ε/V))·g`` with ``p = exp(x − lse)``, computed in f32
    (f64 for an f64 input) and returned in the logits' dtype."""
    acc = _acc(logits)
    x = logits.to(acc)
    v = x.shape[-1]
    lse = lse.to(acc)[:, None]
    p = torch.exp(x - lse)
    if z_loss:
        p = p * (1.0 + 2.0 * float(z_loss) * lse)
    onehot = torch.zeros_like(x).scatter_(-1, labels[:, None].long(), 1.0)
    eps = float(label_smoothing)
    target = (1.0 - eps) * onehot + eps / v if eps else onehot
    return ((p - target) * g.to(acc)[:, None]).to(logits.dtype)


def check_ce_inputs(logits, labels):
    if logits.dim() != 2 or logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError(f'CE takes logits as [N, V] with N, V >= 1, got '
                         f'{tuple(logits.shape)}')
    if tuple(labels.shape) != (logits.shape[0],):
        raise ValueError(f'labels {tuple(labels.shape)} must be '
                         f'[{logits.shape[0]}]')
    if labels.device != logits.device:
        raise ValueError(f'logits and labels devices differ: '
                         f'{logits.device}, {labels.device}')


def clamp_labels(labels, v: int):
    """Labels clamped to [0, V), contiguous: int32 on the card (the
    kernels' type), int64 on the CPU (``gather``'s)."""
    dtype = torch.int32 if labels.device.type == 'cuda' else torch.int64
    return labels.to(dtype).clamp(0, v - 1).contiguous()


def _library():
    lib = _build.library('fused_ce')
    if lib.fused_ce_forward.argtypes is None:
        ptr, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        fwd = lib.fused_ce_forward
        # x, y, loss, lse; N, V; ld; dtype; z, eps; stream
        fwd.argtypes = [ptr] * 4 + [i, i, ll, i, d, d, ptr]
        fwd.restype = i
        bwd = lib.fused_ce_backward
        # x, y, lse, g, dx; N, V; ld; dtype; z, eps; stream
        bwd.argtypes = [ptr] * 5 + [i, i, ll, i, d, d, ptr]
        bwd.restype = i
        err = lib.fused_ce_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _kernel_operands(logits):
    """(row stride, dtype code) for a launch; raises on what the kernels
    do not take."""
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f'fused_ce takes float32, bfloat16 or float16 '
                         f'logits, got {logits.dtype}')
    if logits.stride(1) != 1 or logits.stride(0) < logits.shape[1]:
        raise ValueError(f'fused_ce takes [N, V] logits with unit stride '
                         f'along V and rows at least V apart, got strides '
                         f'{logits.stride()}')
    return logits.stride(0), _DTYPE_CODES[logits.dtype]


def _fail(lib, what, err, logits):
    raise RuntimeError(
        f'{what} launch failed: CUDA error {err} '
        f'({lib.fused_ce_error_string(err).decode()}) at N, V = '
        f'{tuple(logits.shape)}')


def _use_kernel(logits, impl: str) -> bool:
    """True for a launch, False for the plain version, from a resolved
    ``impl``; raises on a CPU tensor with ``cuda`` and on other
    devices."""
    if impl == 'cuda' and logits.device.type != 'cuda':
        raise ValueError(f"fused CE impl 'cuda' needs CUDA tensors, got "
                         f'device {logits.device}')
    if impl == 'dense' or logits.device.type == 'cpu':
        return False
    if logits.device.type != 'cuda':
        raise ValueError(f'fused CE runs on cuda (or cpu: plain version), '
                         f'got device {logits.device}')
    return True


def _prepare(logits, labels, impl: str):
    """What each public entry does once: checks the shapes, clamps the
    labels to [0, V) (``clamp_labels``) and resolves ``impl``."""
    check_ce_inputs(logits, labels)
    return (clamp_labels(labels, logits.shape[1]),
            _build.resolve_impl(impl, 'impl'))


def ce_forward(logits, labels, z_loss: float = 0.0,
               label_smoothing: float = 0.0, impl: str = 'auto',
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Per-row ``(loss, lse)``, f32 [N] each, over [N, V] logits and [N]
    labels (clamped to [0, V)). ``impl`` as ``softmax_ce_per_example``'s;
    ``out`` (the kernel only): two contiguous f32 [N] tensors to write."""
    labels, impl = _prepare(logits, labels, impl)
    return _ce_forward(logits, labels, z_loss, label_smoothing,
                       _use_kernel(logits, impl), out)


def _ce_forward(logits, labels, z_loss, label_smoothing, kernel: bool,
                out=None):
    """``ce_forward`` on labels ``_prepare`` gave."""
    if not kernel:
        if out is not None:
            raise ValueError("out= is the kernel's; the plain version "
                             'returns new tensors')
        return reference_ce_fwd(logits, labels, z_loss, label_smoothing)
    n, v = logits.shape
    ld, code = _kernel_operands(logits)
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=logits.device),
               torch.empty(n, dtype=torch.float32, device=logits.device))
    for t in out:
        if t.shape != (n,) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != logits.device:
            raise ValueError(f'out must be two contiguous f32 [{n}] on '
                             f'{logits.device}')
    loss, lse = out
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.fused_ce_forward(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), n, v, ld, code, float(z_loss),
            float(label_smoothing),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        _fail(lib, 'fused_ce forward', err, logits)
    ce_forward.launches += 1
    softmax_ce_per_example.launches += 1
    return loss, lse


def ce_backward(logits, labels, lse, g, z_loss: float = 0.0,
                label_smoothing: float = 0.0, impl: str = 'auto',
                out: Optional[torch.Tensor] = None):
    """The logits' gradient [N, V] in their dtype from the forward's lse
    and the per-row loss gradient ``g`` [N]. ``out`` (the kernel only): a
    contiguous [N, V] tensor of the logits' dtype to write."""
    labels, impl = _prepare(logits, labels, impl)
    return _ce_backward(logits, labels, lse, g, z_loss, label_smoothing,
                        _use_kernel(logits, impl), out)


def _ce_backward(logits, labels, lse, g, z_loss, label_smoothing,
                 kernel: bool, out=None):
    """``ce_backward`` on labels ``_prepare`` gave."""
    if not kernel:
        if out is not None:
            raise ValueError("out= is the kernel's; the plain version "
                             'returns a new tensor')
        return reference_ce_bwd(logits, labels, lse, g, z_loss,
                                label_smoothing)
    n, v = logits.shape
    ld, code = _kernel_operands(logits)
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    if out is None:
        out = torch.empty((n, v), dtype=logits.dtype, device=logits.device)
    elif out.shape != (n, v) or out.dtype != logits.dtype \
            or not out.is_contiguous() or out.device != logits.device:
        raise ValueError(f'out must be a contiguous {logits.dtype} '
                         f'[{n}, {v}] on {logits.device}')
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.fused_ce_backward(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), out.data_ptr(), n, v, ld, code, float(z_loss),
            float(label_smoothing),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        _fail(lib, 'fused_ce backward', err, logits)
    ce_backward.launches += 1
    softmax_ce_per_example.launches += 1
    return out


ce_forward.launches = 0
ce_backward.launches = 0


class FusedCE(torch.autograd.Function):
    """``_fused_ce``'s custom_vjp: the forward kernel gives (loss, lse),
    only (logits, labels, lse) are saved, and the backward kernel gives
    the logits' gradient; the labels get none."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, label_smoothing, kernel):
        """``labels`` as ``_prepare`` gives them; ``kernel`` is
        ``_use_kernel``'s verdict."""
        loss, lse = _ce_forward(logits, labels, z_loss, label_smoothing,
                                kernel)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (z_loss, label_smoothing, kernel)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        dx = _ce_backward(logits, labels, lse, g, *ctx.args)
        return dx, None, None, None, None


def softmax_ce_per_example(logits, labels, block_n: int = 256,
                           block_v: int = 1024, impl: str = 'auto',
                           interpret: bool = False, z_loss: float = 0.0,
                           label_smoothing: float = 0.0):
    """Per-example softmax CE over [N, V] logits and [N] int labels, f32
    losses (module docstring for ``impl``). ``block_n``, ``block_v`` and
    ``interpret`` are the TPU kernel's and are accepted for the JAX
    signature's sake; ``interpret=True`` reads as ``impl='auto'`` where
    ``impl`` is ``pallas``, as the JAX tests pass it.

    ``z_loss`` adds ``z * logsumexp^2`` per example; ``label_smoothing``
    is the usual eps-smoothed target mix. Labels outside [0, V) are
    clamped to the nearest valid index."""
    if impl == 'pallas' and interpret:
        impl = 'interpret'
    labels, impl = _prepare(logits, labels, impl)
    if impl == 'dense':
        return reference_ce(logits, labels, z_loss=z_loss,
                            label_smoothing=label_smoothing)
    return FusedCE.apply(logits, labels, float(z_loss),
                         float(label_smoothing), _use_kernel(logits, impl))


softmax_ce_per_example.launches = 0


__all__ = ['softmax_ce_per_example', 'reference_ce', 'reference_ce_fwd',
           'reference_ce_bwd', 'ce_forward', 'ce_backward', 'FusedCE']

"""The fused multi-layer serving stack: one hand-written CUDA launch for
an L-layer chain at small batch, and its plain PyTorch version.

Port of ``mlcomp_tpu/ops/serving_stack.py``. The TPU's Pallas kernel
``_stack_kernel`` (launched by ``serving_stack``) becomes
``csrc/serving_stack.cu``: one persistent cooperative launch of
8-block clusters that split K, each block keeping its slice of the
activation in shared memory and streaming its slab of each layer's
weights on the wgmma tile of ``int8_gemm.cuh``; the cluster adds its
partial sums through distributed shared memory, and the grid meets at a
barrier for the feed's global max (the file's header says what bounds
it on the card).

- ``reference_stack``: the plain version, ``y_l = x_l @ dequant(W_l).T
  (· s_l)``, ``x_{l+1} = stack_feed(y_l)`` (or y in bf16 without the
  feed), the last layer's f32 y returned (before any feed).
- ``serving_stack``: the kernel's wrapper, the JAX signature. A CPU
  tensor takes the plain version; a CUDA tensor launches the kernel or
  raises. ``interpret`` reads as every wrapper of the port reads it, as
  ``auto``: it changes neither route (``reference_stack`` is the plain
  version on any device).
  ``block_n`` / ``block_k`` are the TPU kernel's tiling contract,
  checked as there (a call the JAX package refuses is refused here); the
  CUDA kernel tiles by its own 128-channel chunks and takes any N = K
  (zero-padded to a multiple of 16, TMA's rule).
  ``serving_stack.launches`` counts the launches.
- ``quantize_stack``, ``stack_feed``, ``FEED_EPS``: as in the JAX
  package; ``stack_feed`` is the one definition of the feed the kernel,
  the plain version and the harnesses share.
- ``make_chain_runner``: the bench leg's timed chain, as a plain runner:
  ``reps`` stacks back to back on the tensors' device, one
  synchronisation at the end. A CUDA graph is later work.
"""

import ctypes
import time
from typing import Sequence, Tuple

import torch

from mlcomp_tpu_torch.ops import _build
from mlcomp_tpu_torch.ops.int8_matmul import (
    TMA_K, quantize_int8, tma_operand,
)

FEED_EPS = 1e-6
_WDTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1}


def stack_feed(y):
    """The inter-layer renormalization of the bench chain: y over its
    global max-abs (+ FEED_EPS), rounded to bf16."""
    return (y / (y.abs().max() + FEED_EPS)).to(torch.bfloat16)


def reference_stack(x, w_stack, scales=None, feed: bool = True):
    """Plain chain: y_l = x_l @ dequant(W_l).T (bf16 operands, f32
    products and sums); x_{l+1} = stack_feed(y_l) (or bf16(y_l) without
    the feed). ``w_stack`` [L, N, K] int8 or bf16; ``scales`` [L, N] or
    None. Returns the LAST layer's f32 output (pre-feed)."""
    y = None
    for li in range(w_stack.shape[0]):
        if li > 0:
            x = stack_feed(y) if feed else y.to(torch.bfloat16)
        y = x.to(torch.bfloat16).float() @ \
            w_stack[li].to(torch.bfloat16).float().t()
        if scales is not None:
            y = y * scales[li].float()[None, :]
    return y


def check_stack_inputs(x, w_stack, scales, block_n: int, block_k: int):
    m, kdim = x.shape
    n_l, n, k2 = w_stack.shape
    if k2 != kdim or n != kdim:
        raise ValueError(
            f'stack needs square layers matching x: x {tuple(x.shape)}, '
            f'w_stack {tuple(w_stack.shape)}')
    if n % block_n or kdim % block_k:
        raise ValueError(
            f'({n}, {kdim}) does not tile by ({block_n}, {block_k})')
    if scales is not None and tuple(scales.shape) != (n_l, n):
        raise ValueError(f'scales {tuple(scales.shape)} must be '
                         f'[{n_l}, {n}]')
    devices = {x.device, w_stack.device} | (
        set() if scales is None else {scales.device})
    if len(devices) > 1:
        raise ValueError(f'x, w_stack, scales devices differ: {devices}')


def _library():
    lib = _build.library('serving_stack')
    fn = lib.serving_stack
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # x_in, x_buf, w, scales, out, scratch (pointers); L, M, K, wdtype,
        # feed; stream
        fn.argtypes = [ptr] * 6 + [i] * 5 + [ptr]
        fn.restype = i
        lib.serving_stack_slots.argtypes = [i]
        lib.serving_stack_slots.restype = i
        lib.serving_stack_grid.argtypes = [i, i]
        lib.serving_stack_grid.restype = i
        err = lib.serving_stack_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _launch(x, w_stack, scales, feed: bool):
    n_l, n, k = w_stack.shape
    m = x.shape[0]
    if w_stack.dtype not in _WDTYPE_CODES or not w_stack.is_contiguous():
        raise ValueError(f'serving_stack takes a contiguous int8 or bf16 '
                         f'w_stack, got {w_stack.dtype} with strides '
                         f'{w_stack.stride()}')
    # TMA's rule (int8_matmul.TMA_K): the width zero-padded to a multiple
    # of 16 — padded channels come out 0, add 0 to the feed's max and
    # feed 0 on
    k_pad = -(-k // TMA_K) * TMA_K
    x = tma_operand(x.to(torch.bfloat16), k_pad)
    if k_pad != k:
        w_stack = torch.nn.functional.pad(w_stack,
                                          (0, k_pad - k, 0, k_pad - k))
        if scales is not None:
            scales = torch.nn.functional.pad(scales.float(), (0, k_pad - k))
    elif w_stack.data_ptr() % 16:
        w_stack = w_stack.clone()
    if scales is not None:
        scales = scales.float().contiguous()
    out = torch.empty((m, k_pad), dtype=torch.float32, device=x.device)
    x_buf = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        scratch = torch.empty(lib.serving_stack_slots(k_pad),
                              dtype=torch.float32, device=x.device)
        err = lib.serving_stack(
            x.data_ptr(), x_buf.data_ptr(), w_stack.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n_l, m, k_pad, _WDTYPE_CODES[w_stack.dtype],
            int(bool(feed)), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f'serving_stack launch failed: CUDA error {err} '
            f'({lib.serving_stack_error_string(err).decode()}) at L={n_l} '
            f'M={m} K={k} {w_stack.dtype}')
    serving_stack.launches += 1
    return out if k_pad == k else out[:, :k].contiguous()


def stack_grid(k: int, wdtype=torch.int8) -> int:
    """The CTAs the kernel launches for width ``k`` on the current card
    (clusters of 8 CTAs, as many as the card holds at once)."""
    k_pad = -(-k // TMA_K) * TMA_K
    grid = _library().serving_stack_grid(k_pad, _WDTYPE_CODES[wdtype])
    if grid <= 0:
        raise RuntimeError(f'serving_stack occupancy query failed: CUDA '
                           f'error {-grid}')
    return grid


def serving_stack(x, w_stack, scales=None, feed: bool = True,
                  block_n: int = 1024, block_k: int = 2048,
                  interpret: bool = False):
    """Run the fused stack. ``x`` [M, K] (any float dtype), ``w_stack``
    [L, N, K] with N == K, ``scales`` [L, N] f32 or None (bf16 weights).
    Returns f32 [M, N] — the last layer's pre-feed output. The kernel
    for CUDA tensors, the plain version for CPU tensors; ``interpret``
    (JAX's flag) is ``auto`` and routes nothing."""
    check_stack_inputs(x, w_stack, scales, block_n, block_k)
    if x.device.type == 'cpu':
        return reference_stack(x, w_stack, scales, feed=feed)
    if x.device.type != 'cuda':
        raise ValueError(f'serving_stack runs on cuda (or cpu: plain '
                         f'version), got device {x.device}')
    return _launch(x, w_stack, scales, feed)


serving_stack.launches = 0


def quantize_stack(ws: Sequence) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float weights -> stacked ([L, N, K] int8, [L, N] f32) via
    the serving quantizer."""
    qs, ss = zip(*(quantize_int8(w) for w in ws))
    return torch.stack(qs), torch.stack(ss)


def make_chain_runner(step, args, x0, reps: int, recorder=None,
                      metric: str = 'serving.chain_ms'):
    """The bench leg's timed chain: ``step(x, *args)`` runs ONE stack;
    returns a no-arg callable that runs ``reps`` of them back to back on
    the tensors' device, synchronises once (the float of the final x's
    sum) and returns that float.

    ``recorder`` (a telemetry ``MetricRecorder``) observes each call
    after the first — the first builds and warms — as the per-stack
    wall-clock ms under ``metric``, so ``histogram_summaries()`` gives
    its p50/p99 beside the min-based figures."""
    warmed = [False]

    def call():
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = x0
            for _ in range(reps):
                x = step(x, *args)
            out = float(x.float().sum())
        if recorder is not None and warmed[0]:
            recorder.observe(metric,
                             (time.perf_counter() - t0) / reps * 1e3)
        warmed[0] = True
        return out
    return call


__all__ = ['serving_stack', 'reference_stack', 'quantize_stack',
           'stack_grid', 'stack_feed', 'make_chain_runner', 'FEED_EPS',
           'check_stack_inputs']

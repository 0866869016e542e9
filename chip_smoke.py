#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mlcomp_tpu_torch``) on one
NVIDIA card — the quickest proof that the port still builds, is right,
serves and trains on the GPU.

    python3 chip_smoke.py [--seed N]

It imports nothing of JAX or of the JAX package ``mlcomp_tpu``. Phases,
one line of output each (or more), any failure exits non-zero before the
last line:

1. device: the card's name and power limit (``nvidia-smi``), torch, CUDA
   and nvcc versions;
2. build: every kernel under ``mlcomp_tpu_torch/csrc/`` with nvcc, timed,
   with ptxas's register / spill report and wgmma advisories, and the
   HGMMA (wgmma) instructions in the SASS of every 16-bit instantiation
   of the attention forward and the two backward kernels and of every
   instantiation of the int8 matmul and the serving stack (cuobjdump;
   none fails the run);
3. kernels: each kernel's wrapper on tensors on the card against its
   plain PyTorch version at several shapes (the main path's shape first),
   by the largest relative error of an output row (see
   ``mlcomp_tpu_torch/testing/kernel_check.py``), with its time, the
   plain version's time, one PyTorch library call's time as a
   yardstick, and the least time the card could take (bytes over
   3.35 TB/s or operations over the dtype's peak): the forward at the
   serving shapes (timed at the serving shape, and with its lse at B=1
   with the flagship's 16 heads and the wide LM's 32, each beside SDPA
   and as a share of the card's peak), then the forward's lse and the
   two backward kernels
   at the training shapes (also held against torch autograd through the
   plain version, per head), timed at both training shapes (the
   flagship's 16 heads and the wide LM's 32) beside SDPA's backward, and
   run twice there for bitwise-equal gradients;
4. norm kernel: the fused batch-norm+ReLU kernel against its plain
   version (run in f64) at the CIFAR ResNet-18's norm sites at batch 512
   and 256 (the step's and the executor's; with and without the ReLU)
   and at ragged shapes in fp16 and f32 (``kernel_check.NORM_SHAPES``),
   by the mean, var and per-channel y errors, then timed by CUDA events
   at each site shape of the step (inputs rotated through more than the
   L2 cache; back-to-back calls, so host launch gaps are included)
   against its bound, its plain version and
   ``F.batch_norm(training=True)`` + ``F.relu``;
5. int8 kernels: the int8 matmul against its plain version run in f64
   at the bench's shape, the served LM's and ragged ones, and at the
   wgmma tiles' edges (``kernel_check.INT8_SHAPES``, a NaN canary after
   the output), its fused ``Int8Dense`` epilogue (bias, bf16 / fp16 out)
   bit for bit against the unfused formula
   (``kernel_check.INT8_EPILOGUE_SHAPES``), timed at the four main-path
   shapes beside its bound, the plain version and ``torch.matmul`` on
   bf16 weights; the serving stack per layer against f64 and over the
   chain against ``reference_stack`` (``kernel_check.STACK_SHAPES``),
   run twice at the bench's shape for bitwise-equal outputs, timed at
   8 × 8192² at M = 64 in int8 and bf16 beside the bf16 chain;
6. serving: the flagship transformer LM (vocab 32768, d_model 1024, 16
   heads, d_ff 4096, 8 layers, T=8192, bf16 activations, f32 params;
   weights from a seed) exported with the port's ``export_model``,
   served by ``ModelServer(device='cuda')`` and asked over HTTP; the
   launch counts are zeroed just before the requests and read just
   after, and one row's logits are held against the same model with the
   plain attention;
7. int8 serving: the flagship exported per layer and served with
   ``quantize='int8'`` (25 int8 launches a dispatch), then the stacked
   export (the head alone: 1); counts zeroed just before the requests,
   read just after; one row against the same int8 weights through the
   plain product and against the unquantized model; weight bytes; where
   one dispatch of the per-layer export goes (``[serve-int8-split]``,
   profiler: the int8 kernel by shape, ``Int8Dense``'s passes around
   it, attention, the rest, the device's busy share);
8. ``serving_int8``: ``bench.py``'s leg (8 layers of 8192² at M = 64, 7
   interleaved trials × 100 stacks through ``make_chain_runner``): bf16
   chain, plain int8 chain, per-layer int8 kernel, int8 and bf16 stack
   kernel; the ratio of the min times, the paired range, p50/p99 from
   the recorder's ``histogram_summaries``;
9. train: ``Executor.from_config('train', config)`` on the card — the
   flagship at batch 1 over an npz of random tokens, AdamW with
   ``warmup_cosine``, one epoch, checkpoints and a ``model_name`` export
   that ``make_predictor`` then loads; the launch counts are zeroed just
   before and read just after (8 forward and 8 of each backward kernel
   per step);
10. CIFAR train: ``Executor.from_config('train', config)`` on the card
   with ``examples/cifar_simple/config.yml``'s train executor (ResNet-18
   at full width, ``norm: fused``, ``synthetic_images`` 8192/1024, batch
   256, AdamW ``warmup_cosine``, ``device_data: auto``, ``mesh: {dp:
   -1}``) for one epoch: checkpoints, the export loaded by
   ``make_predictor`` and served by ``ModelServer`` over HTTP; the norm
   kernel's launch count zeroed just before and read just after (20 per
   train step, none in eval);
11. CIFAR step: ResNet-18 at batch 512 with SGD (lr 0.1, momentum 0.9)
   as ``bench.py``'s CIFAR legs run it, ``norm: batch`` and ``norm:
   fused`` from the same weights on the same batch: step ms and
   images/s for each (timed in turns), the norm's share of the step and
   the longest kernels (profiler), and the cosine of every parameter's
   gradient between the two variants;
12. step: the flagship's train step as ``bench.py``'s ``bench_lm``
   measures it (B=1, T=8192, AdamW): tokens/s, MFU, device time, the
   attention share of it and the step's longest kernels (profiler), and
   one step's gradients against the same weights with the plain
   attention (cosine per parameter tensor);
13. norm device time: the fused norm kernels' own device time per call
   (profiler) at each site shape of the step, with and without the ReLU;
14. the ``{"kernels": [...]}`` line, the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Phases of the int8 training slice, run among the above (ce-kernels and
int8-train after the int8 kernels, train-wide-int8 after train,
step-wide after step):

- int8-train: ``int8_train_matmul`` (``torch._int_mm`` on the card: a
  library call, no kernel of the port's) and both its gradients against
  autograd through its STE oracle run in f32, by relative L2 error
  (``kernel_check.INT8_TRAIN_SHAPES``: the wide step's ``qkv`` with bf16
  masters, its ``wo`` with f32 params);
- ce-kernels: the blocked cross-entropy's forward and backward kernels
  against their plain versions run in f64 (``kernel_check.CE_SHAPES``:
  the wide LM step's 8191 × 32768 bf16 with each (z, ε) of {0, 1e-4} ×
  {0, 0.1}, bench_fused_ce's 8192 × 32768, ragged shapes in fp16 and
  f32, strided rows; labels partly out of range; NaN canaries after
  loss, lse and dx), timed at the step's shape beside their bounds,
  their plain versions and ``F.cross_entropy`` (its autograd for the
  backward);
- train-wide-int8: ``Executor.from_config('train', config)`` on the
  wide LM of ``bench_lm`` (d_model 2048, 32 heads, d_ff 8192, 8 layers,
  T=8192, 687,900,672 parameters) with ``matmul_precision: int8``,
  ``param_dtype: bfloat16``, AdamW with ``master_dtype: bfloat16`` and
  ``loss: {name: lm_ce, impl: pallas, z_loss: 1e-4, label_smoothing:
  0.1}``: one epoch over an npz of random tokens, checkpoints, the
  export loaded by ``make_predictor``; launch counts zeroed just before
  and read just after (per step 1 CE forward and 1 backward, 8 flash
  forwards and 8 of each backward; no serving int8 launch);
- step-wide: ``bench_lm``'s wide legs on the same weights, timed in
  turns: (a) bf16, (b) int8 with bf16 masters (``lm_wide_int8_vs_bf16``),
  (c) int8 with the fused-CE kernels, z-loss and smoothing, (d) that
  loss dense; step ms, tokens/s, MFU; the CE kernels' and ``_int_mm``'s
  device time in (c) (profiler), the quantize passes, the dense CE and
  the two [N, V] passes around the kernels (CUDA events); checks (c)
  against (d) (logits-gradient cosine, loss) and (a) against (b) (every
  parameter's gradient cosine).

Without CUDA, or in a directory that holds this script and nothing else
of the repository, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: published peaks of one H100 SXM (dense, no sparsity) at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}
#: a train step's gradients vs the same weights with plain attention:
#: least cosine similarity of any parameter tensor's gradient (bf16
#: activations; the kernels round P and dS to bf16 where the plain
#: attention keeps f32)
MIN_GRAD_COSINE = 0.99
#: batch-vs-fused train step of the CIFAR ResNet-18: least cosine of
#: any parameter's gradient (bf16 activations; the fused variant's
#: backward runs in f32 where cuDNN's rounds differently)
MIN_NORM_GRAD_COSINE = 0.99
#: the residual branches' end scale in the gradient comparison
BRANCH_SCALE = 0.2
CIFAR_STEP_BATCH = 512
CIFAR_STEP_ITERS = 10
#: bytes the norm timing rotates its inputs through, past the 50 MB L2
ROTATE_BYTES = 256 << 20
#: rows of 8192 random tokens in the train phase's npz: 4 train, 1 valid
TRAIN_ROWS = 5
STEP_ITERS = 5
#: kernels of the step printed with their device time, longest first
TOP_KERNELS = 12
#: served LM vs the same weights with plain attention: cosine similarity
#: of the [T, V] logits, and top-1 agreement where a pick counts when its
#: reference logit is within TIE_DELTA (two bf16 ulps at logits of 4-8)
#: of the reference maximum — bf16 logits of random weights tie often
MIN_COSINE = 0.999
MIN_TOP1 = 0.99
TIE_DELTA = 0.0625
#: the int8-served LM against the same weights unquantized: cosine of
#: the [T, V] logits. Per-channel absmax/127 rounding moves each
#: projection's output by ~1% (a rounding error of scale/√12 against
#: columns whose absmax is ~4σ); through 8 layers and the head the
#: logits stay within a few percent, a cosine above 0.999 — 0.99 leaves
#: room for the bf16 activations' own rounding
MIN_INT8_COSINE = 0.99

FLAGSHIP = {'name': 'transformer_lm', 'vocab_size': 32768, 'd_model': 1024,
            'n_layers': 8, 'n_heads': 16, 'd_ff': 4096, 'max_seq_len': 8192,
            'dtype': 'bfloat16'}
SERVE_BATCH = 4
REQUEST_ROWS = (1, 4, 2, 3) * 3


def fail(msg: str):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def say(phase: str, **fields):
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1-2
def phase_device():
    smi = nvidia_smi_line()
    nvcc_v = 'not found'
    from mlcomp_tpu_torch.ops import _build
    try:
        out = subprocess.run([_build.nvcc(), '--version'],
                             capture_output=True, text=True, timeout=60)
        nvcc_v = out.stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        fail(str(e))
    say('device', card=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_v),
        python=sys.version.split()[0])
    return smi


#: the wgmma kernels by their kernels-line entry: (library, kernel); and
#: the HGMMA instructions in their SASS ({'instantiations', 'min_hgmma'}),
#: which phase_build reads with cuobjdump
WGMMA_KERNELS = {
    'flash_attention_fwd': ('flash_attention_fwd', 'fa_fwd_wgmma_kernel'),
    'flash_attention_bwd_dq': ('flash_attention_bwd',
                               'fa_bwd_dq_wgmma_kernel'),
    'flash_attention_bwd_dkv': ('flash_attention_bwd',
                                'fa_bwd_dkv_wgmma_kernel'),
    'int8_matmul': ('int8_matmul', 'int8_wgmma_kernel'),
    'serving_stack': ('serving_stack', 'stack_wgmma_kernel')}
SASS_COUNTS = {}


def sass_hgmma(path: str):
    """{SASS function name: HGMMA instructions} of a built library, from
    the toolkit's cuobjdump (or Triton's copy); None without one."""
    from mlcomp_tpu_torch.ops import _build
    tools = [os.path.join(os.path.dirname(_build.nvcc()), 'cuobjdump')]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  'backends', 'nvidia', 'bin', 'cuobjdump'))
    except ImportError:
        pass
    tool = next((x for x in tools if os.path.exists(x)), None)
    if tool is None:
        return None
    out = subprocess.run([tool, '-sass', path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f'cuobjdump -sass {path}: {out.stderr.strip()[:500]}')
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if 'Function :' in line:
            name = line.split('Function :')[-1].strip()
            counts[name] = 0
        elif name is not None and 'HGMMA' in line:
            counts[name] += 1
    return counts


def phase_build():
    from mlcomp_tpu_torch.ops import _build
    t0 = time.monotonic()
    try:
        libs = _build.build()
    except RuntimeError as e:
        fail(str(e))
    seconds = time.monotonic() - t0
    for name, path in libs.items():
        log = _build.BUILD_LOGS.get(name, {}).get('log', '(cached)')
        # the register and spill report, and every wgmma advisory
        # (C7512, C7515, ...)
        lines = [ln.split('ptxas info    : ')[-1] for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln
                 or 'entry function' in ln or re.search(r'\(C75\d\d\)', ln)]
        say('build', kernel=name, seconds=f'{seconds:.1f}',
            library=os.path.relpath(path, HERE))
        for ln in lines:
            print(f'    ptxas: {ln}', flush=True)
    # proof that wgmma was emitted: HGMMA in every instantiation's SASS
    sass = {lib: sass_hgmma(libs[lib]) for lib, _ in WGMMA_KERNELS.values()}
    if None in sass.values():
        say('sass', hgmma='not measured (no cuobjdump)')
    for entry, (lib, kernel) in WGMMA_KERNELS.items():
        counts = sass[lib]
        if counts is None:
            continue
        found = [c for f, c in counts.items() if kernel in f]
        say('sass', kernel=kernel, instantiations=len(found),
            hgmma_min=min(found, default=0), hgmma_max=max(found, default=0))
        if not found or min(found) == 0:
            fail(f'{kernel}: no HGMMA in the SASS of some instantiation')
        SASS_COUNTS[entry] = {'instantiations': len(found),
                              'min_hgmma': min(found)}
    return libs


# ---------------------------------------------------------------- phase 3
def attention_bound_ms(b, t, h, d, dtype, causal):
    """Least time for the work: every q·k pair the mask leaves live, two
    multiply-adds per element of D for QKᵀ and PV; each of q, k, v read
    once and out written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * size
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def phase_kernels(seed: int):
    from mlcomp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, reference_attention,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        ATTENTION_ROW_TOL, ATTENTION_SHAPES, qkv_views, row_relative_error,
    )
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    # the serving shape first, and only it timed
    for i, (b, t, h, d, dtype, causal) in enumerate(ATTENTION_SHAPES):
        timed = i == 0
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        try:
            out = flash_attention_forward(q, k, v, causal=causal)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'flash_attention_fwd at B={b} T={t} H={h} D={d} '
                 f'{dtype} causal={causal}: {e}')
        ref = reference_attention(q, k, v, causal=causal, round_p=True)
        err = float((out.float() - ref.float()).abs().max())
        row_err = row_relative_error(out, ref)
        tol = ATTENTION_ROW_TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and row_err <= tol
        fields = dict(shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
                      causal=causal, row_err=f'{row_err:.3e}', tol=tol,
                      max_abs_err=f'{err:.3e}')
        if timed:
            bound, bound_by = attention_bound_ms(b, t, h, d, dtype, causal)
            ms = time_ms(lambda: flash_attention_forward(
                q, k, v, causal=causal), iters=20)
            plain_ms = time_ms(lambda: reference_attention(
                q, k, v, causal=causal, round_p=True), iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=20)
            fields.update(ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.3f}',
                          library_ms=f'{library_ms:.4f}',
                          bound_ms=f'{bound:.4f}', bound_by=bound_by,
                          pct_of_peak=f'{100 * bound / ms:.1f}')
            main = {'name': 'flash_attention_fwd', 'route': 'cuda',
                    'source': 'mlcomp_tpu_torch/csrc/flash_attention_fwd.cu',
                    'replaces': 'mlcomp_tpu/ops/flash_attention.py:83',
                    'design': 'wgmma + TMA, three consumer warpgroups '
                              'taking turns',
                    'sass_hgmma': SASS_COUNTS.get('flash_attention_fwd'),
                    'max_abs_err': err, 'row_err': row_err,
                    'ms': ms, 'plain_ms': plain_ms,
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': library_ms,
                    'shape': [b, t, h, d], 'dtype': str(dtype)[6:],
                    'causal': causal}
        say('kernel', ok=ok, **fields)
        if not ok:
            fail(f'flash_attention_fwd disagrees with reference_attention '
                 f'at {fields}')
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    # the training steps' forward: with lse at B=1, the flagship's 16
    # heads and the wide LM's 32
    main['lse_b1'] = {}
    for b, t, h, d, dtype, causal in ((1, 8192, 16, 64, torch.bfloat16, True),
                                      (1, 8192, 32, 64, torch.bfloat16, True)):
        q, k, v = qkv_views(b, t, h, d, dtype, gen)
        bound, _ = attention_bound_ms(b, t, h, d, dtype, causal)
        ms = time_ms(lambda: flash_attention_forward(
            q, k, v, causal=causal, with_lse=True), iters=20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20)
        say('kernel-lse', shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
            causal=causal, ms=f'{ms:.4f}', sdpa_ms=f'{library_ms:.4f}',
            bound_ms=f'{bound:.4f}', pct_of_peak=f'{100 * bound / ms:.1f}')
        main['lse_b1'][f'H={h}'] = {'ms': ms, 'library_ms': library_ms,
                                    'bound_ms': bound}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return main


def backward_bound_ms(b, t, h, d, dtype, causal, products, n_in, n_out):
    """Least time for a backward: ``products`` matrix products of 2·D
    operations for every live (query, key) pair; ``n_in`` [B, T, H, D]
    inputs and the f32 row statistics (lse, delta: two [B, H, T]) read
    once, ``n_out`` gradients written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 2 * products * b * h * d * pairs
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n_in + n_out) * b * t * h * d * size + 2 * b * h * t * 4
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def _fields(errors: dict) -> str:
    return ','.join(f'{n}:{e:.3e}' for n, e in errors.items())


def phase_backward_kernels(seed: int):
    """The forward's lse and both backward kernels against their plain
    versions at every backward shape; both training shapes timed, and
    each run twice for bitwise-equal gradients. Returns the kernels
    line's entries for the two backward kernels."""
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.testing.kernel_check import (
        AUTOGRAD_HEAD_TOL, BACKWARD_HEAD_TOL, BACKWARD_ROW_TOL,
        BACKWARD_SHAPES, LSE_TOL, backward_check, backward_ok,
    )
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for b, t, h, d, dtype, causal in BACKWARD_SHAPES:
        shape = (b, t, h, d, dtype, causal)
        try:
            r = backward_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'flash attention backward at B={b} T={t} H={h} D={d} '
                 f'{dtype} causal={causal}: {e}')
        ok = backward_ok(r, dtype)
        say('kernel-bwd', ok=ok, shape=f'{b}x{t}x{h}x{d}',
            dtype=str(dtype)[6:], causal=causal,
            lse_err=f'{r["lse_err"]:.3e}', lse_tol=LSE_TOL,
            row_err=_fields(r['row_err']), tol=BACKWARD_ROW_TOL[dtype],
            head_err=_fields(r['head_err']),
            head_tol=BACKWARD_HEAD_TOL[dtype],
            autograd_head_err=_fields(r['autograd_head_err']),
            autograd_tol=AUTOGRAD_HEAD_TOL[dtype])
        if not ok:
            fail(f'flash attention backward disagrees with its plain '
                 f'version at {shape}: {r}')
        if shape == BACKWARD_SHAPES[0]:
            main = r
        torch.cuda.empty_cache()

    # both training shapes (the flagship's 16 heads, the wide LM's 32),
    # timed: forward with lse, each backward kernel, the whole backward,
    # the plain versions, and scaled_dot_product_attention forward and
    # backward as the library yardstick; each also run twice for
    # bitwise-equal gradients
    timed = {}
    for shape in BACKWARD_SHAPES[:2]:
        timed[shape[2]] = _time_backward(shape, gen, fa, F)
    b, t, h, d, dtype, causal = BACKWARD_SHAPES[0]
    flagship, wide = timed[h], timed[BACKWARD_SHAPES[1][2]]
    entries = []
    for name, products, n_out, grads in (
            ('flash_attention_bwd_dq', 3, 1, ('dq',)),
            ('flash_attention_bwd_dkv', 4, 2, ('dk', 'dv'))):
        ms_key = 'dq_ms' if n_out == 1 else 'dkv_ms'
        kb, kb_by = backward_bound_ms(b, t, h, d, dtype, causal, products,
                                      4, n_out)
        wb, _ = backward_bound_ms(*BACKWARD_SHAPES[1], products, 4, n_out)
        entries.append({
            'name': name, 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/flash_attention_bwd.cu',
            'replaces': 'mlcomp_tpu/ops/flash_attention.py:'
                        + ('309' if n_out == 1 else '336'),
            'redesigned': 'PR 6',
            'max_abs_err': max(main['max_abs_err'][g] for g in grads),
            'row_err': max(main['row_err'][g] for g in grads),
            'ms': flagship[ms_key], 'plain_ms': flagship['plain_bwd_ms'],
            'bound_ms': kb, 'bound_by': kb_by, 'library_ms': None,
            'sdpa_bwd_ms': flagship['sdpa_bwd_ms'],
            'bwd_ms': flagship['bwd_ms'],
            'bitwise_equal_over_two_runs': flagship['bitwise_equal'],
            'sass_hgmma': SASS_COUNTS.get(name),
            'shape': [b, t, h, d], 'dtype': str(dtype)[6:],
            'causal': causal,
            'wide': {'shape': list(BACKWARD_SHAPES[1][:4]),
                     'ms': wide[ms_key], 'bound_ms': wb,
                     'plain_ms': wide['plain_bwd_ms'],
                     'sdpa_bwd_ms': wide['sdpa_bwd_ms'],
                     'bwd_ms': wide['bwd_ms']}})
    torch.cuda.empty_cache()
    return entries


def _time_backward(shape, gen, fa, F) -> dict:
    """Times of the backward at a training shape (CUDA events), and
    whether two runs of it give bitwise-equal dq, dk and dv."""
    from mlcomp_tpu_torch.testing.kernel_check import qkv_views
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen)
    do = torch.randn((b, t, h, d), generator=gen, device='cuda',
                     dtype=torch.float32).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
    delta = fa.attention_delta(out, do)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    again = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(first, again))
    if not bitwise:
        fail(f'the backward kernels gave different gradients in two runs '
             f'at {shape}')
    del first, again
    fwd_ms = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, with_lse=True), iters=20)
    dq_ms = time_ms(lambda: fa.flash_attention_backward_dq(
        q, k, v, do, lse, delta, causal=causal), iters=20)
    dkv_ms = time_ms(lambda: fa.flash_attention_backward_dkv(
        q, k, v, do, lse, delta, causal=causal), iters=20)
    bwd_ms = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, causal=causal), iters=20)
    plain_fwd_ms = time_ms(lambda: fa.reference_attention(
        q, k, v, causal=causal, with_lse=True), iters=2)
    torch.cuda.empty_cache()
    plain_bwd_ms = time_ms(lambda: fa.reference_attention_backward(
        q, k, v, out, lse, do, causal=causal), iters=2)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    sdpa_ms = time_ms(sdpa_fwd_bwd, iters=20)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True), iters=20)
    fwd_bound, _ = attention_bound_ms(b, t, h, d, dtype, causal)
    bound, bound_by = backward_bound_ms(b, t, h, d, dtype, causal, 5, 5, 3)
    say('kernel-bwd', shape=f'{b}x{t}x{h}x{d}', dtype=str(dtype)[6:],
        causal=causal, fwd_lse_ms=f'{fwd_ms:.4f}',
        fwd_bound_ms=f'{fwd_bound:.4f}', bwd_ms=f'{bwd_ms:.4f}',
        dq_ms=f'{dq_ms:.4f}', dkv_ms=f'{dkv_ms:.4f}',
        bwd_bound_ms=f'{bound:.4f}', bwd_bound_by=bound_by,
        fwd_bwd_ms=f'{fwd_ms + bwd_ms:.4f}',
        sdpa_fwd_bwd_ms=f'{sdpa_ms:.4f}', sdpa_bwd_ms=f'{sdpa_bwd_ms:.4f}',
        plain_fwd_lse_ms=f'{plain_fwd_ms:.3f}',
        plain_bwd_ms=f'{plain_bwd_ms:.3f}', bitwise_equal=bitwise)
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot, o_lib
    torch.cuda.empty_cache()
    return {'dq_ms': dq_ms, 'dkv_ms': dkv_ms, 'bwd_ms': bwd_ms,
            'plain_bwd_ms': plain_bwd_ms, 'sdpa_bwd_ms': sdpa_bwd_ms,
            'bitwise_equal': bitwise}


# ---------------------------------------------------------------- phase 4
def flagship_params(seed: int) -> dict:
    """The flagship LM's weights in the JAX parameter layout (stacked
    ``layers``), from a seed: normal(0.02) embeddings, lecun-normal
    projections, unit norm scales — f32, as the JAX trainer keeps them."""
    rng = np.random.default_rng(seed)
    cfg = FLAGSHIP
    v, m, n_l = cfg['vocab_size'], cfg['d_model'], cfg['n_layers']
    h, f, s = cfg['n_heads'], cfg['d_ff'], cfg['max_seq_len']
    d = m // h

    def normal(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x

    return {
        'embed': normal((v, m), 0.02),
        'pos_embed': normal((s, m), 0.02),
        'layers': {
            'norm_attn': {'scale': np.ones((n_l, m), np.float32)},
            'attn': {'qkv': {'kernel': normal((n_l, m, 3, h, d), m ** -0.5)},
                     'out': {'kernel': normal((n_l, h, d, m),
                                              (h * d) ** -0.5)}},
            'norm_mlp': {'scale': np.ones((n_l, m), np.float32)},
            'mlp': {'wi_gate': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wi_up': {'kernel': normal((n_l, m, f), m ** -0.5)},
                    'wo': {'kernel': normal((n_l, f, m), f ** -0.5)}}},
        'norm_final': {'scale': np.ones((m,), np.float32)},
        'lm_head': {'kernel': normal((m, v), m ** -0.5)},
    }


def _http(port, path, body=None, token=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if body is None else json.dumps(body).encode(),
        headers={'Authorization': token} if token else {})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def top1_agreement(logits, ref):
    """(raw, tie-aware) share of positions whose argmax over ``logits``
    is the argmax over ``ref`` (see TIE_DELTA)."""
    pick = logits.argmax(dim=-1)
    ref_max, ref_pick = ref.max(dim=-1)
    raw = float((pick == ref_pick).float().mean())
    picked = ref.gather(-1, pick.unsqueeze(-1)).squeeze(-1)
    tie = float((picked >= ref_max - TIE_DELTA).float().mean())
    return raw, tie


def phase_serving(seed: int):
    from mlcomp_tpu_torch import MODEL_FOLDER, TOKEN
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.flash_attention import flash_attention_forward
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model

    t0 = time.monotonic()
    params = flagship_params(seed)
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'flagship_lm'), params,
                 FLAGSHIP, meta={'input_shape': [FLAGSHIP['max_seq_len']],
                                 'input_dtype': 'int32'})
    del params
    path = resolve_model('flagship_lm', 'smoke')
    export_s = time.monotonic() - t0
    t0 = time.monotonic()
    server = ModelServer(path, batch_size=SERVE_BATCH, activation='argmax',
                         port=0, device='cuda')
    load_s = time.monotonic() - t0
    t0 = time.monotonic()
    if not server.warmup():
        fail('export carries no input_shape to warm up with')
    warm_s = time.monotonic() - t0
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    model = server.primary.predict.model
    say('serve', export_s=f'{export_s:.1f}', load_s=f'{load_s:.1f}',
        warmup_s=f'{warm_s:.2f}', port=server.port,
        params=sum(p.numel() for p in model.parameters()))
    try:
        rng = np.random.default_rng(seed + 1)
        t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
        requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                    for n in REQUEST_ROWS]
        latencies, served = [], []
        # the main path: counts zeroed just before, read just after
        flash_attention_forward.launches = 0
        per_dispatch = []
        for x in requests:
            before = flash_attention_forward.launches
            t1 = time.monotonic()
            out = _http(server.port, '/predict', {'x': x.tolist()}, TOKEN)
            latencies.append((time.monotonic() - t1) * 1e3)
            per_dispatch.append(flash_attention_forward.launches - before)
            y = np.asarray(out['y'])
            if y.shape != x.shape or not np.issubdtype(y.dtype, np.integer) \
                    or y.min() < 0 or y.max() >= vocab:
                fail(f'/predict answered shape {y.shape} dtype {y.dtype} '
                     f'for {x.shape} tokens')
            served.append(y)
        launches = flash_attention_forward.launches
        health = _http(server.port, '/health')
        say('serve', requests=len(requests), rows=list(REQUEST_ROWS),
            launches=launches, per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}',
            health_p50_ms=health['models']['flagship_lm']['latency_ms'][
                'p50'],
            health=health['status'], platform=health['platform'],
            device=repr(health['device']))
        if health['status'] != 'ok' or health['platform'] != 'gpu' \
                or health['requests'] != len(requests):
            fail(f'/health disagrees: {health}')
        if per_dispatch != [FLAGSHIP['n_layers']] * len(requests):
            fail(f'expected {FLAGSHIP["n_layers"]} flash launches per '
                 f'dispatch, got {per_dispatch}')

        # where a dispatch's time goes: the model's forward at the served
        # batch shape on the card, against the request as the client saw it
        batch = torch.from_numpy(np.concatenate(requests[:2])[:SERVE_BATCH]
                                 ).cuda()
        with torch.inference_mode():
            forward_ms = time_ms(lambda: model(batch).argmax(dim=-1),
                                 iters=3)
        say('serve', forward_ms=f'{forward_ms:.2f}',
            batch=SERVE_BATCH)

        # one row against the same weights with the plain attention
        tokens = torch.from_numpy(requests[0]).cuda()
        dense = create_model(**{**FLAGSHIP, 'attn_impl': 'dense'},
                             device='cuda')
        dense.load_state_dict(model.state_dict())
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            ref = dense(tokens)[0].float()
        del dense
        finite = bool(torch.isfinite(kern).all() and torch.isfinite(ref).all())
        cos = float(torch.nn.functional.cosine_similarity(
            kern.reshape(1, -1), ref.reshape(1, -1)))
        raw, tie = top1_agreement(kern, ref)
        served_row = torch.from_numpy(served[0][0]).cuda().long()
        picked = ref.gather(-1, served_row[:, None]).squeeze(-1)
        served_tie = float((picked >= ref.max(dim=-1).values - TIE_DELTA)
                           .float().mean())
        say('compare', finite=finite, cosine=f'{cos:.6f}',
            top1_raw=f'{raw:.4f}', top1_tie_aware=f'{tie:.4f}',
            served_top1_tie_aware=f'{served_tie:.4f}',
            max_abs_logit_err=f'{float((kern - ref).abs().max()):.4f}',
            min_cosine=MIN_COSINE, min_top1=MIN_TOP1)
        if not finite or cos < MIN_COSINE or tie < MIN_TOP1 \
                or served_tie < MIN_TOP1:
            fail('served LM disagrees with the plain-attention reference')
        return launches
    finally:
        server.shutdown()
        thread.join(timeout=30)


# ---------------------------------------------------------------- phase 5
def _train_logger():
    """The executor's log lines on stdout, marked as this phase's."""
    import logging
    log = logging.getLogger('chip_smoke.train')
    if not log.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter('[train]   %(message)s'))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


def phase_train(seed: int) -> dict:
    """The training entry point at the flagship width on the card;
    returns the launches of each kernel in its run."""
    import gc
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.worker.executors import Executor

    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_train_')
    cwd = os.getcwd()
    try:
        tokens = np.random.default_rng(seed + 2).integers(
            0, vocab, (TRAIN_ROWS, t), dtype=np.int32)
        data = os.path.join(work, 'tokens.npz')
        np.savez(data, x=tokens, y=tokens)
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': {
            'type': 'train',
            'model': {**FLAGSHIP, 'attn_impl': 'auto'},
            'dataset': {'name': 'npz', 'path': data},
            'loss': 'lm_ce', 'batch_size': 1,
            'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                'name': 'adamw', 'lr': 3e-4,
                'schedule': {'name': 'warmup_cosine'}}}],
            'main_metric': 'loss', 'minimize': True,
            'checkpoint_dir': ck_dir, 'model_name': 'flagship_lm_trained',
            'seed': seed, 'device': 'cuda'}}}
        os.chdir(work)          # the export lands in models/ under it
        executor = Executor.from_config('train', config)
        n_train = int(TRAIN_ROWS * 0.8)       # the npz loader's split
        n_valid = TRAIN_ROWS - n_train
        counters = {'flash_attention_fwd': fa.flash_attention_forward,
                    'flash_attention_bwd_dq': fa.flash_attention_backward_dq,
                    'flash_attention_bwd_dkv':
                        fa.flash_attention_backward_dkv}
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        layers = FLAGSHIP['n_layers']
        want = {'flash_attention_fwd': layers * (n_train + n_valid),
                'flash_attention_bwd_dq': layers * n_train,
                'flash_attention_bwd_dkv': layers * n_train}
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', 'flagship_lm_trained')
        say('train', steps=n_train, valid_rows=n_valid,
            seconds=f'{train_s:.1f}', valid_loss=result['best_score'],
            params=result['n_params'], launches=launches,
            checkpoints=files)
        if launches != want:
            fail(f'expected launches {want} (8 forward per step and per '
                 f'valid batch, 8 of each backward kernel per step), '
                 f'got {launches}')
        if not np.isfinite(result['best_score']):
            fail(f'train loss is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        predict = make_predictor(export, batch_size=1, activation='argmax',
                                 device='cuda')
        y = predict(tokens[:1])
        ok = y.shape == (1, t) and 0 <= y.min() and y.max() < vocab
        say('train', export=os.path.basename(export), predictor_device=str(
            next(predict.model.parameters()).device), predict_shape=y.shape,
            ok=ok)
        if not ok:
            fail(f'the trained export predicts {y.shape} {y.dtype}')
        del predict
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6
def _device_times_us(prof, is_part) -> tuple:
    """(all kernels' device time in a profile, us; that of the kernels
    whose name ``is_part`` accepts; the kernels by time, [(us, name),
    ...] longest first)."""
    total = part = 0.0
    by_name = []
    for event in prof.key_averages():
        us = getattr(event, 'self_device_time_total', None)
        if us is None:
            us = getattr(event, 'self_cuda_time_total', 0.0)
        total += us
        if is_part(event.key):
            part += us
        if us > 0:
            by_name.append((us, event.key))
    return total, part, sorted(by_name, reverse=True)


def phase_step(seed: int):
    """The flagship's train step at B=1, T=8192 as bench_lm measures it,
    and one step's gradients against the plain attention."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    layers, d = FLAGSHIP['n_layers'], FLAGSHIP['d_model']
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (1, t)).astype(np.int32)).cuda()
    loss_fn = loss_for_task('lm_ce')
    model = create_model(**FLAGSHIP, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(seed))
    n_params = param_count(model)

    def grads(m):
        loss, _ = loss_fn(m(tokens, train=True), tokens)
        return dict(zip((n for n, _ in m.named_parameters()),
                        torch.autograd.grad(loss, list(m.parameters()))))

    kernel = grads(model)
    # the plain attention keeps [T, T] f32 scores per layer: remat keeps
    # one layer's at a time
    dense = create_model(**{**FLAGSHIP, 'attn_impl': 'dense',
                            'remat': True}, device='cuda')
    dense.load_state_dict(model.state_dict())
    plain = grads(dense)
    del dense
    cosines = {n: float(F.cosine_similarity(
        kernel[n].flatten().float(), plain[n].flatten().float(), dim=0))
        for n in kernel}
    worst = min(cosines, key=cosines.get)
    del kernel, plain
    torch.cuda.empty_cache()

    optimizer, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4}, 1000)
    state = create_train_state(model, optimizer, seed=seed)
    step = make_train_step(model, optimizer, loss_fn, self_supervised=True)
    for _ in range(3):                   # warm-up, as bench_lm does
        state, metrics = step(state, tokens, None)
    step_ms = time_ms(lambda: step(state, tokens, None), iters=STEP_ITERS,
                      warmup=0)
    loss = float(step(state, tokens, None)[1]['loss'])
    tok_s = t / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 6 * layers * t * d
    mfu = tok_s * flops_per_token / PEAK_OPS_PER_S[torch.bfloat16]
    fields = dict(params=n_params, step_ms=f'{step_ms:.2f}',
                  tokens_per_s=f'{tok_s:.1f}', mfu=f'{mfu:.4f}',
                  loss=f'{loss:.4f}')
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(state, tokens, None)
            torch.cuda.synchronize()
        total_us, attention_us, by_name = _device_times_us(
            prof, lambda key: 'fa_fwd' in key or 'fa_bwd' in key)
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
        for us, name in by_name[:TOP_KERNELS]:
            say('step-kernel', ms_per_step=f'{us / 2e3:.3f}',
                share=f'{us / total_us:.4f}', name=repr(name[:90]))
        fields.update(device_ms=f'{total_us / 2e3:.2f}',
                      attention_ms=f'{attention_us / 2e3:.2f}',
                      attention_share=f'{attention_us / total_us:.4f}',
                      device_busy=f'{total_us / 2e3 / step_ms:.4f}')
    except Exception as e:      # the profiler is untried on that machine
        fields.update(device_ms='not measured', profiler=repr(str(e)[:80]))
    say('step', **fields)
    say('step', grad_min_cosine=f'{cosines[worst]:.6f}', worst=worst,
        mean_cosine=f'{sum(cosines.values()) / len(cosines):.6f}',
        tensors=len(cosines), min_cosine=MIN_GRAD_COSINE)
    if not np.isfinite(loss):
        fail(f'train step loss is not finite: {loss}')
    if not cosines[worst] >= MIN_GRAD_COSINE:
        fail(f'gradients disagree with the plain attention: {worst} '
             f'cosine {cosines[worst]}')
    del state, model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def norm_bound_ms(r, c, dtype):
    """Least time for the norm: x read once and y written once (gamma,
    beta, mean and var are [C] f32), or ~6 f32 operations per element
    (square-add, sum, subtract, multiply-add, max) over the card's f32
    peak outside the tensor cores, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * r * c * size + 4 * c * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 6 * r * c / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def time_rotating_ms(fn, inputs, iters: int) -> float:
    """``time_ms`` of ``fn(*inputs[i % len])``: each launch reads inputs
    the previous ones did not, so they come from device memory and not
    from L2, as a norm site's activation does at batch 512."""
    count = [0]

    def call():
        fn(*inputs[count[0] % len(inputs)])
        count[0] += 1
    return time_ms(call, iters=iters, warmup=len(inputs))


def rotating_norm_inputs(r, c, gen) -> list:
    """bf16 norm inputs at [R, C], as many copies as make ROTATE_BYTES
    (at least 8)."""
    from mlcomp_tpu_torch.testing.kernel_check import norm_inputs
    copies = max(8, -(-ROTATE_BYTES // (r * c * 2)))
    return [norm_inputs(r, c, torch.bfloat16, gen) for _ in range(copies)]


def phase_norm_kernel(seed: int) -> dict:
    """The fused norm kernel against its plain version at every norm
    shape; timed at the CIFAR sites. Returns its kernels-line entry."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.ops.fused_norm import (
        norm_act_forward, reference_norm_act,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        NORM_SHAPES, NORM_STAT_TOL, NORM_Y_TOL, cifar_norm_sites, norm_check,
        norm_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    main = None
    for shape in NORM_SHAPES:
        r_, c, dtype, act = shape
        try:
            r = norm_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'fused_norm at R={r_} C={c} {dtype} act={act}: {e}')
        ok = norm_ok(r, dtype)
        say('kernel-norm', ok=ok, shape=f'{r_}x{c}', dtype=str(dtype)[6:],
            act=act, mean_err=f'{r["mean_err"]:.3e}',
            var_err=f'{r["var_err"]:.3e}', stat_tol=NORM_STAT_TOL,
            y_err=f'{r["y_err"]:.3e}', tol=NORM_Y_TOL[dtype],
            max_abs_err=f'{r["max_abs_err"]:.3e}')
        if not ok:
            fail(f'fused_norm disagrees with reference_norm_act at {shape}: '
                 f'{r}')
        if main is None:
            main = dict(r, shape=[r_, c], dtype=str(dtype)[6:])
        torch.cuda.empty_cache()

    # timed at each CIFAR site shape of the step (bf16, with the ReLU) by
    # CUDA events over back-to-back calls: host launch gaps included,
    # which hold the small sites (``profile_norm_sites`` reads the
    # kernels' own device time)
    sites = {}
    for r_, c in cifar_norm_sites(CIFAR_STEP_BATCH):
        hw = int(round((r_ / CIFAR_STEP_BATCH) ** 0.5))
        inputs = rotating_norm_inputs(r_, c, gen)
        ms = time_rotating_ms(lambda x, g, b: norm_act_forward(x, g, b),
                              inputs, iters=max(20, 2 * len(inputs)))
        plain_ms = time_rotating_ms(lambda x, g, b: reference_norm_act(
            x, g, b), inputs, iters=max(5, len(inputs)))
        # the library yardstick on the same memory, as NCHW channels_last
        lib_inputs = [(x.view(CIFAR_STEP_BATCH, hw, hw, c).permute(
            0, 3, 1, 2), g, b) for x, g, b in inputs]
        library_ms = time_rotating_ms(lambda x, g, b: F.relu(F.batch_norm(
            x, None, None, g, b, training=True)), lib_inputs,
            iters=max(20, 2 * len(inputs)))
        bound, bound_by = norm_bound_ms(r_, c, torch.bfloat16)
        sites[f'{r_}x{c}'] = dict(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound,
                                  bound_by=bound_by)
        say('kernel-norm', shape=f'{r_}x{c}', dtype='bfloat16', act=True,
            ms=f'{ms:.4f}', bound_ms=f'{bound:.4f}', bound_by=bound_by,
            two_pass_bound_ms=f'{bound * 1.5:.4f}',
            plain_ms=f'{plain_ms:.4f}', library_ms=f'{library_ms:.4f}',
            gbytes_per_s=f'{2 * r_ * c * 2 / ms / 1e6:.1f}',
            timing='cuda_events_with_host_gaps')
        del inputs, lib_inputs
        torch.cuda.empty_cache()
    first = sites[f'{main["shape"][0]}x{main["shape"][1]}']
    return {'name': 'fused_norm', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/fused_norm.cu',
            'replaces': 'mlcomp_tpu/ops/fused_norm.py:83',
            'max_abs_err': main['max_abs_err'], 'y_err': main['y_err'],
            'mean_err': main['mean_err'], 'var_err': main['var_err'],
            **first, 'shape': main['shape'], 'dtype': main['dtype'],
            'timing': 'cuda_events_with_host_gaps', 'sites': sites}


def profile_norm_sites(seed: int) -> dict:
    """The fused norm kernels' own device time per call (profiler) at
    each CIFAR site shape of the step, with and without the ReLU, on
    rotating inputs; {'RxC': {'act': ms, 'no_act': ms}}."""
    from torch.profiler import ProfilerActivity, profile
    from mlcomp_tpu_torch.ops.fused_norm import norm_act_forward
    from mlcomp_tpu_torch.testing.kernel_check import cifar_norm_sites
    gen = torch.Generator(device='cuda').manual_seed(seed)
    out = {}
    for r_, c in cifar_norm_sites(CIFAR_STEP_BATCH):
        inputs = rotating_norm_inputs(r_, c, gen)
        bound, _ = norm_bound_ms(r_, c, torch.bfloat16)
        out[f'{r_}x{c}'] = {}
        for act in (True, False):
            for x, g, b in inputs:                      # warm
                norm_act_forward(x, g, b, act=act)
            torch.cuda.synchronize()
            ms = None
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for x, g, b in inputs:
                        norm_act_forward(x, g, b, act=act)
                    torch.cuda.synchronize()
                _, norm_us, _ = _device_times_us(prof,
                                                 _is_norm_kernel(True))
                if norm_us > 0:
                    ms = norm_us / len(inputs) / 1e3
            except Exception as e:      # the profiler's view of the card
                say('kernel-norm-device', profiler=repr(str(e)[:80]))
            out[f'{r_}x{c}']['act' if act else 'no_act'] = ms
            say('kernel-norm-device', shape=f'{r_}x{c}', dtype='bfloat16',
                act=act, calls=len(inputs),
                device_ms='not measured' if ms is None else f'{ms:.4f}',
                bound_ms=f'{bound:.4f}',
                two_pass_bound_ms=f'{bound * 1.5:.4f}')
        del inputs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 8
def cifar_train_spec() -> dict:
    """``examples/cifar_simple/config.yml``'s train executor, as the
    port runs it: ``type: train`` and the model's ``norm: fused``."""
    return {
        'type': 'train',
        'model': {'name': 'resnet18', 'num_classes': 10,
                  'dtype': 'bfloat16', 'norm': 'fused'},
        'dataset': {'name': 'synthetic_images', 'n_train': 8192,
                    'n_valid': 1024, 'image_size': 32, 'channels': 3,
                    'num_classes': 10},
        'loss': 'softmax_ce', 'batch_size': 256, 'mesh': {'dp': -1},
        'main_metric': 'accuracy', 'model_name': 'cifar_resnet18',
        'device_data': 'auto',
        'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
            'name': 'adamw', 'lr': 0.001,
            'schedule': {'name': 'warmup_cosine'}}}]}


def phase_cifar_train(seed: int) -> int:
    """ResNet-18 with the fused norm trained through the executor on the
    card, its export served; returns the norm kernel's launches."""
    import gc
    from mlcomp_tpu_torch import TOKEN
    from mlcomp_tpu_torch.ops.fused_norm import norm_act_forward
    from mlcomp_tpu_torch.server.serve import ModelServer
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.utils.msgpack_io import msgpack_restore
    from mlcomp_tpu_torch.worker.executors import Executor

    work = tempfile.mkdtemp(prefix='mlcomp_smoke_cifar_')
    cwd = os.getcwd()
    spec = cifar_train_spec()
    try:
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': dict(
            spec, checkpoint_dir=ck_dir, seed=seed, device='cuda')}}
        os.chdir(work)          # the export lands in models/ under it
        executor = Executor.from_config('train', config)
        # the main path: counts zeroed just before, read just after
        norm_act_forward.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = norm_act_forward.launches
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        steps = spec['dataset']['n_train'] // spec['batch_size']
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', spec['model_name'])
        say('cifar-train', steps=steps, seconds=f'{train_s:.1f}',
            valid_accuracy=result['best_score'], params=result['n_params'],
            samples_per_s=f'{result["samples_per_sec"]:.1f}',
            launches=launches, checkpoints=files)
        if launches != 20 * steps:
            fail(f'expected {20 * steps} fused_norm launches (20 norm sites '
                 f'per train step, none in eval), got {launches}')
        if not np.isfinite(result['best_score']):
            fail(f'CIFAR valid accuracy is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        with open(os.path.join(ck_dir, 'last.msgpack'), 'rb') as fh:
            if 'batch_stats' not in msgpack_restore(fh.read()):
                fail('the CIFAR checkpoint holds no batch_stats')

        data = create_dataset(**spec['dataset'])
        x, y = data['x_valid'][:64], data['y_valid'][:64]
        predict = make_predictor(export, batch_size=16, activation='argmax',
                                 device='cuda')
        want = predict(x)
        accuracy = float((want == y).mean())
        server = ModelServer(export + '.msgpack', batch_size=16,
                             activation='argmax', port=0, device='cuda')
        if not server.warmup():
            fail('the CIFAR export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            got, latencies = [], []
            for start, n in ((0, 1), (1, 16), (17, 7), (24, 40)):
                t1 = time.monotonic()
                out = _http(server.port, '/predict',
                            {'x': x[start:start + n].tolist()}, TOKEN)
                latencies.append((time.monotonic() - t1) * 1e3)
                got.append(np.asarray(out['y']))
            got = np.concatenate(got)
            health = _http(server.port, '/health')
        finally:
            server.shutdown()
            thread.join(timeout=30)
        say('cifar-serve', requests=len(latencies), rows=len(got),
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            served_accuracy=f'{accuracy:.4f}',
            agrees_with_predictor=bool(np.array_equal(got, want)),
            platform=health['platform'], device=repr(health['device']))
        if got.shape != (64,) or not np.array_equal(got, want) \
                or got.min() < 0 or got.max() >= 10:
            fail(f'/predict answered {got} where the predictor gives {want}')
        if health['platform'] != 'gpu':
            fail(f'/health disagrees: {health}')
        del predict, server
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 9
def _open_branches(model):
    """Every residual branch's end scale (zero at init, which would leave
    the branches without a gradient to compare) set to BRANCH_SCALE.
    Random norm scales instead make a per-tensor cosine meaningless: at
    bf16 the gradients of the norms' scales and biases are then sums
    that cancel to a small remainder, which rounding moves by a large
    share even between two runs of one variant."""
    from mlcomp_tpu_torch.models.resnet import BatchNorm, FusedNormAct
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, FusedNormAct)) and m.zero_scale:
                m.scale.fill_(BRANCH_SCALE)


def _is_norm_kernel(fused: bool):
    """The profile's norm kernels: the three of ``fused_norm.cu``, or
    the library's batch-norm kernels."""
    if fused:
        return lambda key: any(k in key for k in (
            'norm_stats_kernel', 'norm_finalize_kernel', 'norm_apply_kernel'))
    return lambda key: 'batch_norm' in key or 'bn_' in key


def phase_cifar_step(seed: int) -> dict:
    """ResNet-18's train step at batch 512, ``norm: batch`` against
    ``norm: fused`` from the same weights on the same batch. Returns the
    profiled device ms per step of each variant's norm kernels (the
    fused variant's: its 20 launches, three kernels each)."""
    import torch.nn.functional as F
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.train.data import create_dataset
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    gen = torch.Generator('cuda').manual_seed(seed)
    spec = {'name': 'resnet18', 'num_classes': 10, 'dtype': 'bfloat16'}
    fused = create_model(**spec, norm='fused', device='cuda', generator=gen)
    _open_branches(fused)
    plain = create_model(**spec, norm='batch', device='cuda')
    plain.load_state_dict(fused.state_dict())
    n_params = param_count(fused)
    data = create_dataset('synthetic_images', n_train=CIFAR_STEP_BATCH,
                          n_valid=1, seed=seed)
    x = torch.from_numpy(data['x_train']).cuda()
    y = torch.from_numpy(data['y_train']).cuda()
    loss_fn = loss_for_task('softmax_ce')

    def grads(m):
        loss, _ = loss_fn(m(x, train=True), y)
        return dict(zip((n for n, _ in m.named_parameters()),
                        torch.autograd.grad(loss, list(m.parameters()))))

    g_fused, g_plain = grads(fused), grads(plain)
    cosines = {n: float(F.cosine_similarity(
        g_fused[n].flatten().float(), g_plain[n].flatten().float(), dim=0))
        for n in g_fused}
    worst = min(cosines, key=cosines.get)
    del g_fused, g_plain

    steps, norm_ms = {}, {}
    for name, model in (('batch', plain), ('fused', fused)):
        optimizer, _ = make_optimizer(
            {'name': 'sgd', 'lr': 0.1, 'momentum': 0.9}, 1000)
        state = create_train_state(model, optimizer, seed=seed)
        step = make_train_step(model, optimizer, loss_fn)
        for _ in range(3):
            state, metrics = step(state, x, y)
        steps[name] = (state, step)
    times = {'batch': [], 'fused': []}
    for name in ('batch', 'fused', 'fused', 'batch'):     # in turns
        state, step = steps[name]
        times[name].append(time_ms(lambda: step(state, x, y),
                                   iters=CIFAR_STEP_ITERS, warmup=0))
    for name in ('batch', 'fused'):
        state, step = steps[name]
        loss = float(step(state, x, y)[1]['loss'])
        step_ms = sum(times[name]) / len(times[name])
        fields = dict(norm=name, params=n_params, batch=CIFAR_STEP_BATCH,
                      step_ms=f'{step_ms:.3f}',
                      runs_ms=[f'{t:.3f}' for t in times[name]],
                      images_per_s=f'{CIFAR_STEP_BATCH / step_ms * 1e3:.1f}',
                      loss=f'{loss:.4f}')
        try:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(state, x, y)
                torch.cuda.synchronize()
            total_us, norm_us, by_name = _device_times_us(
                prof, _is_norm_kernel(name == 'fused'))
            if total_us <= 0:
                raise RuntimeError('the profile holds no device time')
            for us, kernel in by_name[:TOP_KERNELS]:
                say('cifar-step-kernel', norm=name,
                    ms_per_step=f'{us / 2e3:.3f}',
                    share=f'{us / total_us:.4f}', name=repr(kernel[:90]))
            norm_ms[name] = norm_us / 2e3
            fields.update(device_ms=f'{total_us / 2e3:.3f}',
                          norm_kernel_ms=f'{norm_us / 2e3:.3f}',
                          norm_kernel_share=f'{norm_us / total_us:.4f}',
                          device_busy=f'{total_us / 2e3 / step_ms:.4f}')
        except Exception as e:      # the profiler's view of the card
            fields.update(device_ms='not measured',
                          profiler=repr(str(e)[:80]))
        say('cifar-step', **fields)
        if not np.isfinite(loss):
            fail(f'CIFAR {name} step loss is not finite: {loss}')
    say('cifar-step', grad_min_cosine=f'{cosines[worst]:.6f}', worst=worst,
        mean_cosine=f'{sum(cosines.values()) / len(cosines):.6f}',
        tensors=len(cosines), min_cosine=MIN_NORM_GRAD_COSINE)
    if not cosines[worst] >= MIN_NORM_GRAD_COSINE:
        fail(f'fused and batch norm gradients disagree: {worst} cosine '
             f'{cosines[worst]}')
    del steps, fused, plain, x, y
    torch.cuda.empty_cache()
    return norm_ms


# ------------------------------------------------------------ int8 serving
def int8_bound_ms(m, k, n):
    """Least time for the int8 product: x (bf16), w_qt (int8) and scale
    read once and the f32 out written once, or 2·M·N·K operations at the
    bf16 tensor-core peak, whichever is larger."""
    nbytes = m * k * 2 + n * k + n * 4 + m * n * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def phase_int8_kernel(seed: int) -> dict:
    """The int8 matmul kernel against its plain version (run in f64) at
    every INT8_SHAPES shape; timed at the bench's shape and the served
    LM's. Returns its kernels-line entry (the top-level times at the
    LM's d_ff projection, the most launched shape of the main path)."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_matmul, reference_int8_matmul,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        INT8_EPILOGUE_SHAPES, INT8_ROW_TOL, INT8_SHAPES, int8_check,
        int8_epilogue_check, int8_epilogue_ok, int8_inputs, int8_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in INT8_SHAPES:
        try:
            r = int8_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'int8_matmul at (M, K, N)={shape}: {e}')
        ok = int8_ok(r)
        say('kernel-int8', ok=ok, shape='x'.join(map(str, shape)),
            row_err=f'{r["row_err"]:.3e}', tol=INT8_ROW_TOL,
            max_abs_err=f'{r["max_abs_err"]:.3e}', canary=r['canary'])
        if not ok:
            fail(f'int8_matmul disagrees with its plain version at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()
    # the fused Int8Dense epilogue, bit for bit
    for shape in INT8_EPILOGUE_SHAPES:
        try:
            r = int8_epilogue_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'int8_matmul epilogue at (M, K, N)={shape}: {e}')
        ok = int8_epilogue_ok(r)
        say('kernel-int8-epilogue', ok=ok, shape='x'.join(map(str, shape)),
            differing_elements=r)
        if not ok:
            fail(f'the fused int8 epilogue differs from the unfused formula '
                 f'at {shape}: {r}')
        torch.cuda.empty_cache()

    timed = {}
    for shape in INT8_SHAPES[:4]:
        m, k, n = shape
        # the bench's 67 MB weight is read from device memory: turns over
        # copies that together exceed the 50 MB L2
        copies = 3 if m <= 64 else 1
        inputs = [int8_inputs(m, k, n, gen) for _ in range(copies)]
        w_bf16 = [w.to(torch.bfloat16) for _, w, _ in inputs]
        iters = 50 if m <= 64 else 10
        ms = time_rotating_ms(lambda x, w, s: int8_matmul(x, w, s),
                              inputs, iters=iters)
        plain_ms = time_rotating_ms(reference_int8_matmul, inputs,
                                    iters=max(3, copies))
        library_convert_ms = time_rotating_ms(lambda x, w, s: torch.matmul(
            x, w.to(torch.bfloat16).t()) * s, inputs, iters=iters)
        bf_inputs = [(x, wb, s) for (x, _, s), wb in zip(inputs, w_bf16)]
        library_ms = time_rotating_ms(lambda x, w, s: torch.matmul(
            x, w.t()) * s, bf_inputs, iters=iters)
        bound, bound_by = int8_bound_ms(m, k, n)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            library_convert_ms=library_convert_ms,
                            bound_ms=bound, bound_by=bound_by)
        say('kernel-int8', shape='x'.join(map(str, shape)), ms=f'{ms:.4f}',
            bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.3f}', library_ms=f'{library_ms:.4f}',
            library_convert_ms=f'{library_convert_ms:.4f}',
            tflops=f'{2 * m * n * k / ms / 1e9:.1f}',
            weight_gbytes_per_s=f'{n * k / ms / 1e6:.1f}')
        del inputs, w_bf16, bf_inputs
        torch.cuda.empty_cache()
    main = INT8_SHAPES[1]
    return {'name': 'int8_matmul', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/int8_matmul.cu',
            'replaces': 'mlcomp_tpu/ops/int8_matmul.py:87',
            'design': 'wgmma + TMA, the int8 weight as the register A '
                      'operand (swap AB), a producer thread, two consumer '
                      'warpgroups, fused Int8Dense epilogue',
            'sass_hgmma': SASS_COUNTS.get('int8_matmul'),
            'max_abs_err': errors[main]['max_abs_err'],
            'row_err': errors[main]['row_err'], **timed[main],
            'shape': list(main), 'library': 'torch.matmul(x, w_bf16.t()) '
                                              '* scale, bf16 weight made '
                                              'beforehand',
            'shapes': {'x'.join(map(str, s)): t for s, t in timed.items()},
            'row_errs': {'x'.join(map(str, s)): r['row_err']
                         for s, r in errors.items()}}


def stack_bound_ms(layers, m, k, wbytes):
    """Least time for the stack: every layer's weight read once, x read
    and the f32 out written once (the activations between layers need not
    leave the chip), or the products at the bf16 peak."""
    nbytes = layers * k * k * wbytes + m * k * 2 + m * k * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * layers * m * k * k / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def bf16_chain(x, ws):
    """The bench's ``bf16`` variant: one bf16 product per layer and the
    feed between them (``ws`` [L, K, N] bf16)."""
    from mlcomp_tpu_torch.ops.serving_stack import stack_feed
    y = None
    for i in range(ws.shape[0]):
        if i:
            x = stack_feed(y)
        y = torch.matmul(x, ws[i])
    return y


def phase_stack_kernel(seed: int) -> dict:
    """The serving-stack kernel against ``reference_stack`` at every
    STACK_SHAPES shape; timed at the bench's 8 × 8192² at M = 64, int8
    and bf16. Returns its kernels-line entry."""
    from mlcomp_tpu_torch.ops.serving_stack import (
        reference_stack, serving_stack, stack_grid,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        STACK_ROW_TOL, STACK_SHAPES, stack_check, stack_inputs, stack_ok,
        stack_tol,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in STACK_SHAPES:
        layers, m, k, wdtype, feed = shape
        try:
            r = stack_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'serving_stack at {shape}: {e}')
        ok = stack_ok(r, layers)
        say('kernel-stack', ok=ok, layers=layers, shape=f'{m}x{k}',
            w=str(wdtype)[6:], feed=feed, row_err=f'{r["row_err"]:.3e}',
            tol=stack_tol(layers), step_err=f'{r["step_err"]:.3e}',
            step_tol=STACK_ROW_TOL['step'],
            max_abs_err=f'{r["max_abs_err"]:.3e}')
        if not ok:
            fail(f'serving_stack disagrees with reference_stack at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()

    timed = {}
    for shape in STACK_SHAPES[:2]:
        layers, m, k, wdtype, feed = shape
        x, w, scales = stack_inputs(layers, m, k, wdtype, gen)
        # deterministic: two runs bitwise equal (no float atomics)
        runs = [serving_stack(x, w, scales, feed=feed, block_n=1024,
                              block_k=2048) for _ in range(2)]
        bitwise = bool(torch.equal(runs[0], runs[1]))
        grid = stack_grid(k, wdtype)
        say('kernel-stack', layers=layers, shape=f'{m}x{k}',
            w=str(wdtype)[6:], bitwise_equal_runs=bitwise, grid=grid,
            clusters=grid // 8)
        if not bitwise:
            fail(f'serving_stack is not deterministic at {shape}')
        del runs
        ms = time_ms(lambda: serving_stack(x, w, scales, feed=feed,
                                           block_n=1024, block_k=2048),
                     iters=50)
        plain_ms = time_ms(lambda: reference_stack(x, w, scales, feed=feed),
                           iters=5)
        # the bench's bf16 chain on the same weights (as bf16 [K, N])
        w_kn = torch.stack([(wl.float() * (1 if scales is None else
                                           scales[i][:, None])).t()
                            .to(torch.bfloat16).contiguous()
                            for i, wl in enumerate(w)])
        chain_ms = time_ms(lambda: bf16_chain(x, w_kn), iters=50)
        bound, bound_by = stack_bound_ms(layers, m, k, w.element_size())
        name = f'{str(wdtype)[6:]}'
        # no one library call computes the stack: library_ms is null and
        # the bench's bf16 chain is the yardstick
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                           bf16_chain_ms=chain_ms, bound_ms=bound,
                           bound_by=bound_by, grid=grid)
        wbytes = layers * k * k * w.element_size()
        say('kernel-stack', layers=layers, shape=f'{m}x{k}', w=name,
            ms=f'{ms:.4f}', bound_ms=f'{bound:.4f}', bound_by=bound_by,
            plain_ms=f'{plain_ms:.3f}', bf16_chain_ms=f'{chain_ms:.4f}',
            weight_gbytes_per_s=f'{wbytes / ms / 1e6:.1f}')
        del x, w, scales, w_kn
        torch.cuda.empty_cache()
    main = STACK_SHAPES[0]
    return {'name': 'serving_stack', 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/serving_stack.cu',
            'replaces': 'mlcomp_tpu/ops/serving_stack.py:67',
            'design': 'one cooperative launch of 8-CTA clusters splitting '
                      'K, x slices resident, the wgmma tile with TMA-'
                      'streamed weights, partial sums reduced through '
                      'distributed shared memory by reducer warps',
            'sass_hgmma': SASS_COUNTS.get('serving_stack'),
            'max_abs_err': errors[main]['max_abs_err'],
            'row_err': errors[main]['row_err'],
            'step_err': errors[main]['step_err'], **timed['int8'],
            'shape': list(main[:3]), 'dtype': 'int8',
            'bf16_weights': timed['bfloat16'],
            'row_errs': {f'{s[0]}x{s[1]}x{s[2]}-{str(s[3])[6:]}-'
                         f'feed{int(s[4])}': r['row_err']
                         for s, r in errors.items()}}


def _model_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def _serve_rows(server, requests, counter) -> tuple:
    """The requests over HTTP: (latencies ms, answers, launches of
    ``counter`` per dispatch)."""
    from mlcomp_tpu_torch import TOKEN
    latencies, served, per_dispatch = [], [], []
    vocab = FLAGSHIP['vocab_size']
    for x in requests:
        before = counter.launches
        t1 = time.monotonic()
        out = _http(server.port, '/predict', {'x': x.tolist()}, TOKEN)
        latencies.append((time.monotonic() - t1) * 1e3)
        per_dispatch.append(counter.launches - before)
        y = np.asarray(out['y'])
        if y.shape != x.shape or not np.issubdtype(y.dtype, np.integer) \
                or y.min() < 0 or y.max() >= vocab:
            fail(f'/predict answered shape {y.shape} dtype {y.dtype} '
                 f'for {x.shape} tokens')
        served.append(y)
    return latencies, served, per_dispatch


def _kernels_under(event) -> list:
    """[(kernel name, device us)] of a profiler event and its CPU
    descendants."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def _is_int8_kernel(name: str) -> bool:
    return 'int8' in name or 'splitk_reduce' in name


#: the profiler label around each Int8Dense.forward (no 'int8' in it: its
#: device-side span must not read as a kernel)
SPLIT_LABEL = 'Int8Dense.forward'


def int8_dispatch_split(predict, batch) -> dict:
    """Where one served dispatch of the per-layer int8 export goes:
    ``predict(batch)`` (batch 4) under ``torch.profiler``. Device time by
    kernel name, from the kernel events themselves (``key_averages``
    would count an op's kernels under the op's key too): the int8 kernel
    (names with int8 or split-K), the attention forward (``fa_fwd``),
    the rest; the int8 kernel by M x K x N, its launches taken in order
    against the order of the ``Int8Dense`` calls; the passes
    ``Int8Dense.forward`` adds around the kernel (bias add, cast: the
    PyTorch ops under a ``record_function`` around each call). The
    device's busy share is the kernel time over the dispatch's time
    without the profiler (host clock after a synchronise, best of 3).
    Prints facts; decides nothing."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense

    forward = Int8Dense.forward
    shapes = []

    def labelled(self, x):
        shapes.append(f'{x.numel() // x.shape[-1]}x{x.shape[-1]}x'
                      f'{self.w_qt.shape[0]}')
        with record_function(SPLIT_LABEL):
            return forward(self, x)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    fields = {'batch': len(batch), 'wall_ms': min(walls)}
    Int8Dense.forward = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            predict(batch)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        # the kernels themselves (not the label's device-side span, a
        # user annotation; not the ops' keys, which carry their kernels'
        # time too), by name
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)]
        per_name = {}
        for e in kernels:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        by_name = sorted(((us, k, n) for k, (us, n) in per_name.items()),
                         reverse=True)
        total_us = sum(us for us, _, _ in by_name)
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
        int8_us = sum(us for us, k, _ in by_name if _is_int8_kernel(k))
        attention_us = sum(us for us, k, _ in by_name if 'fa_fwd' in k)
        launches = sum(n for _, k, n in by_name if _is_int8_kernel(k))
        passes_us = sum(us for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.name == SPLIT_LABEL
                        for name, us in _kernels_under(e)
                        if not _is_int8_kernel(name))
        # the int8 launches in the order they ran, against the calls'
        int8_events = sorted((e for e in kernels if _is_int8_kernel(e.name)),
                             key=lambda e: e.time_range.start)
        by_shape = {}
        if len(int8_events) == len(shapes):
            for shape, e in zip(shapes, int8_events):
                entry = by_shape.setdefault(shape, [0, 0.0])
                entry[0] += 1
                entry[1] += e.time_range.elapsed_us() / 1e3
        fields.update(
            device_ms=total_us / 1e3, busy=total_us / 1e3 / min(walls),
            int8_kernel_ms=int8_us / 1e3, int8_launches=launches,
            int8dense_calls=len(shapes),
            int8dense_passes_ms=passes_us / 1e3,
            attention_ms=attention_us / 1e3,
            rest_ms=(total_us - int8_us - passes_us - attention_us) / 1e3,
            int8_by_shape={s: [n, round(ms, 4)]
                           for s, (n, ms) in sorted(by_shape.items())}
            if by_shape else f'not attributed ({len(int8_events)} '
                             f'events, {len(shapes)} calls)')
        for us, name, count in by_name[:8]:
            say('serve-int8-split-kernel', ms=f'{us / 1e3:.3f}',
                launches=count, name=repr(name[:90]))
    except Exception as e:      # a profiler that reads no device time
        fields.update(device_ms='not measured', profiler=repr(str(e)[:80]))
    finally:
        Int8Dense.forward = forward
    say('serve-int8-split', **{k: (f'{v:.4f}' if isinstance(v, float)
                                   else v) for k, v in fields.items()})
    return fields


def phase_serve_int8(seed: int) -> dict:
    """The flagship served with ``quantize='int8'`` over HTTP, from a
    per-layer export (every MLP projection and the head quantized: 25
    int8 launches a dispatch) and from the stacked export of the serving
    phase (the head alone: 1); one row's logits held against the same
    int8 weights through the plain product, and against the unquantized
    model. Returns the int8 kernel's launches by path."""
    import gc
    from mlcomp_tpu_torch import MODEL_FOLDER
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense, int8_matmul
    from mlcomp_tpu_torch.server.serve import ModelServer, resolve_model
    from mlcomp_tpu_torch.train.export import export_model, make_predictor
    from mlcomp_tpu_torch.train.layer_stack import unstack_layer_tree

    layers = FLAGSHIP['n_layers']
    spec = {**FLAGSHIP, 'scan_layers': False}
    export_model(os.path.join(MODEL_FOLDER, 'smoke', 'flagship_lm_layers'),
                 unstack_layer_tree(flagship_params(seed)), spec,
                 meta={'input_shape': [FLAGSHIP['max_seq_len']],
                       'input_dtype': 'int32'})
    rng = np.random.default_rng(seed + 1)
    t, vocab = FLAGSHIP['max_seq_len'], FLAGSHIP['vocab_size']
    requests = [rng.integers(0, vocab, (n, t), dtype=np.int32)
                for n in REQUEST_ROWS]
    launches = {}
    for name, want in (('flagship_lm_layers', 3 * layers + 1),
                       ('flagship_lm', 1)):
        path = resolve_model(name, 'smoke')
        # the earlier servers' garbage freed first, or the build's delta
        # reads low
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        server = ModelServer(path, batch_size=SERVE_BATCH,
                             activation='argmax', port=0, quantize='int8',
                             device='cuda')
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        int8_bytes = torch.cuda.memory_allocated() - base
        predict = server.primary.predict
        model = predict.model
        if not server.warmup():
            fail('export carries no input_shape to warm up with')
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the main path: counts zeroed just before, read just after
            int8_matmul.launches = 0
            latencies, served, per_dispatch = _serve_rows(
                server, requests, int8_matmul)
            launches[name] = int8_matmul.launches
            health = _http(server.port, '/health')
        finally:
            server.shutdown()
            thread.join(timeout=30)
        say('serve-int8', export=name, quantized=predict.quantized,
            load_s=f'{load_s:.1f}', requests=len(requests),
            launches=launches[name], per_dispatch=per_dispatch,
            p50_ms=f'{float(np.percentile(latencies, 50)):.1f}',
            max_ms=f'{max(latencies):.1f}', platform=health['platform'],
            int8_model_bytes=_model_bytes(model),
            int8_allocated_bytes=int8_bytes)
        if predict.quantized != want or per_dispatch != [want] * len(
                requests):
            fail(f'{name}: expected {want} int8 modules and as many '
                 f'launches a dispatch, got {predict.quantized} and '
                 f'{per_dispatch}')
        if health['platform'] != 'gpu':
            fail(f'/health disagrees: {health}')
        if name != 'flagship_lm_layers':
            del server, predict, model
            continue
        split = int8_dispatch_split(predict, requests[1])

        # one row: the kernel against the plain product on the same int8
        # weights, and against the unquantized model
        tokens = torch.from_numpy(requests[0]).cuda()
        int8_modules = [m for m in model.modules()
                        if isinstance(m, Int8Dense)]
        with torch.inference_mode():
            kern = model(tokens)[0].float()
            for m in int8_modules:
                m.impl = 'dense'
            dense = model(tokens)[0].float()
            for m in int8_modules:
                m.impl = 'auto'
        del server, predict, model
        gc.collect()
        base = torch.cuda.memory_allocated()
        full = make_predictor(path, batch_size=SERVE_BATCH,
                              activation='argmax', device='cuda')
        torch.cuda.synchronize()
        full_bytes = torch.cuda.memory_allocated() - base
        with torch.inference_mode():
            ref = full.model(tokens)[0].float()
        full_model_bytes = _model_bytes(full.model)
        del full
        torch.cuda.empty_cache()
        finite = bool(torch.isfinite(kern).all()
                      and torch.isfinite(dense).all())
        cos = float(torch.nn.functional.cosine_similarity(
            kern.reshape(1, -1), dense.reshape(1, -1)))
        raw, tie = top1_agreement(kern, dense)
        cos_full = float(torch.nn.functional.cosine_similarity(
            kern.reshape(1, -1), ref.reshape(1, -1)))
        raw_full, tie_full = top1_agreement(kern, ref)
        served_row = torch.from_numpy(served[0][0]).cuda().long()
        picked = dense.gather(-1, served_row[:, None]).squeeze(-1)
        served_tie = float((picked >= dense.max(dim=-1).values - TIE_DELTA)
                           .float().mean())
        say('compare-int8', finite=finite, cosine_vs_dense=f'{cos:.6f}',
            top1_tie_aware=f'{tie:.4f}', top1_raw=f'{raw:.4f}',
            served_top1_tie_aware=f'{served_tie:.4f}',
            max_abs_logit_err=f'{float((kern - dense).abs().max()):.4f}',
            min_cosine=MIN_COSINE, min_top1=MIN_TOP1,
            cosine_vs_unquantized=f'{cos_full:.6f}',
            top1_raw_vs_unquantized=f'{raw_full:.4f}',
            top1_tie_aware_vs_unquantized=f'{tie_full:.4f}',
            min_cosine_vs_unquantized=MIN_INT8_COSINE,
            full_model_bytes=full_model_bytes, full_allocated_bytes=full_bytes)
        if not finite or cos < MIN_COSINE or tie < MIN_TOP1 \
                or served_tie < MIN_TOP1:
            fail('the int8 kernel disagrees with the plain int8 product')
        if cos_full < MIN_INT8_COSINE:
            fail(f'the int8-served LM is too far from the unquantized one: '
                 f'cosine {cos_full}')
        del kern, dense, ref, tokens
        torch.cuda.empty_cache()
    return launches, split


def phase_serving_int8(seed: int) -> dict:
    """``bench.py``'s ``serving_int8`` leg on the port: an 8-layer
    K = N = 8192 stack at M = 64 tokens, 7 interleaved trials of 100
    stacks a variant through ``make_chain_runner`` with a recorder.
    Returns the launches of the int8 kernels in it and its numbers."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_matmul, quantize_int8, reference_int8_matmul,
    )
    from mlcomp_tpu_torch.ops.serving_stack import (
        make_chain_runner, serving_stack, stack_feed,
    )
    from mlcomp_tpu_torch.telemetry import MetricRecorder

    m, kn, layers, reps, trials = 64, 8192, 8, 100, 7
    gen = torch.Generator(device='cuda').manual_seed(seed)
    w_bf, packs = [], []
    for _ in range(layers):
        w = torch.randn((kn, kn), generator=gen, device='cuda') * 0.02
        packs.append(quantize_int8(w))
        w_bf.append(w.to(torch.bfloat16))
        del w
    x0 = torch.randn((m, kn), generator=gen, device='cuda').to(
        torch.bfloat16)
    tel = MetricRecorder(component='serving')

    def per_layer(body, args, name):
        def step(x, *a):
            for i in range(layers):
                x = stack_feed(body(x, i, *a))
            return x
        return make_chain_runner(step, args, x0, reps, recorder=tel,
                                 metric=f'serving.{name}_ms')

    flat = [t for pack in packs for t in pack]
    wq = torch.stack([p[0] for p in packs])
    sc = torch.stack([p[1] for p in packs])
    w_t = torch.stack([w.t() for w in w_bf]).contiguous()
    variants = {
        'bf16': per_layer(lambda x, i, *ws: torch.matmul(x, ws[i]), w_bf,
                          'bf16'),
        'int8_dense': per_layer(lambda x, i, *fl: reference_int8_matmul(
            x, fl[2 * i], fl[2 * i + 1]), flat, 'int8_dense'),
        'int8_matmul': per_layer(lambda x, i, *fl: int8_matmul(
            x, fl[2 * i], fl[2 * i + 1]), flat, 'int8_matmul'),
        'int8_stack': make_chain_runner(
            lambda x, wq, sc: stack_feed(serving_stack(
                x, wq, sc, block_n=1024, block_k=2048)),
            [wq, sc], x0, reps, recorder=tel,
            metric='serving.int8_stack_ms'),
        'bf16_stack': make_chain_runner(
            lambda x, w: stack_feed(serving_stack(
                x, w, block_n=1024, block_k=2048)),
            [w_t], x0, reps, recorder=tel, metric='serving.bf16_stack_ms'),
    }
    # the main path of the stack kernel (and of the per-layer int8
    # kernel's chain): counts zeroed just before, read just after
    serving_stack.launches = 0
    int8_matmul.launches = 0
    results = {name: fn() for name, fn in variants.items()}   # warm
    times = {name: [] for name in variants}
    for _ in range(trials):
        for name, fn in variants.items():
            t0 = time.perf_counter()
            results[name] = fn()
            times[name].append(time.perf_counter() - t0)
    launches = {'serving_stack': serving_stack.launches,
                'int8_matmul': int8_matmul.launches}
    if not all(np.isfinite(v) for v in results.values()):
        fail(f'serving_int8 chains are not finite: {results}')
    want = {'serving_stack': 2 * reps * (trials + 1),
            'int8_matmul': layers * reps * (trials + 1)}
    if launches != want:
        fail(f'serving_int8 launches {launches}, expected {want}')

    def ms(name):
        return min(times[name]) / reps * 1e3

    ratios = sorted(b / q for b, q in zip(times['bf16'],
                                          times['int8_stack']))
    hist = {name.split('.')[1][:-3]: s
            for name, s in tel.histogram_summaries().items()}
    out = {
        'serving_int8_speedup': ms('bf16') / ms('int8_stack'),
        'serving_int8_speedup_paired_range': [ratios[0], ratios[-1]],
        'serving_int8_ms': ms('int8_stack'),
        'serving_bf16_ms': ms('bf16'),
        'serving_int8_dense_ms': ms('int8_dense'),
        'serving_int8_matmul_ms': ms('int8_matmul'),
        'serving_stack_bf16_ms': ms('bf16_stack'),
        # the bf16 weights' bytes over the int8 weights' and scales'
        'serving_int8_weight_memory_ratio':
            sum(w.numel() * w.element_size() for w in w_bf)
            / (wq.numel() * wq.element_size()
               + sc.numel() * sc.element_size()),
    }
    say('serving-int8', **{k: (f'{v:.4f}' if isinstance(v, float) else
                               [f'{r:.3f}' for r in v] if isinstance(v, list)
                               else v) for k, v in out.items()},
        launches=launches, trials=trials, reps=reps)
    for name, s in hist.items():
        say('serving-int8-hist', variant=name, count=int(s['count']),
            p50_ms=f'{s["p50"]:.4f}', p99_ms=f'{s["p99"]:.4f}',
            min_ms=f'{s["min"]:.4f}', max_ms=f'{s["max"]:.4f}')
    out['latency_hist'] = hist
    del w_bf, packs, flat, wq, sc, w_t, x0, variants
    torch.cuda.empty_cache()
    return {'launches': launches, 'numbers': out}


# ----------------------------------------------------------- cross-entropy
#: the step's CE operands, timed: B(T-1) = 8191 rows at B = 1, T = 8192,
#: the wide LM's vocabulary, bf16, with the loss's z-loss and smoothing
CE_TIMED = [(8191, 32768, torch.bfloat16, 1e-4, 0.1),
            (8192, 32768, torch.bfloat16, 1e-4, 0.1)]


def ce_bound_ms(n, v, dtype, backward: bool):
    """Least time for a CE kernel: forward, x read once, labels read and
    loss and lse written; backward, x, labels, lse and g read and dx
    written — or its f32 operations (forward ~5 an element: max, the
    exponent's FFMA and ex2, the add, the smoothing sum; backward ~6) at
    the card's f32 peak outside the tensor cores, whichever is larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes, ops = 2 * n * v * size + 3 * n * 4, 6 * n * v
    else:
        nbytes, ops = n * v * size + 3 * n * 4, 5 * n * v
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def library_ce(x, labels, z, eps):
    """One PyTorch call per term as the yardstick: ``F.cross_entropy``
    with ``label_smoothing`` (the same function: lse − (1−ε)·x[y] −
    (ε/V)·Σx), plus ``z · logsumexp²`` where z ≠ 0."""
    import torch.nn.functional as F
    loss = F.cross_entropy(x, labels, reduction='none', label_smoothing=eps)
    if z:
        loss = loss + z * torch.logsumexp(x.float(), dim=-1).square()
    return loss


def phase_ce_kernels(seed: int) -> list:
    """The CE forward and backward kernels against their plain versions
    (run in f64) at every CE_SHAPES shape, then timed at the step's and
    bench_fused_ce's shapes. Returns their kernels-line entries."""
    from mlcomp_tpu_torch.ops.fused_ce import (
        ce_backward, ce_forward, reference_ce_bwd, reference_ce_fwd,
    )
    from mlcomp_tpu_torch.testing.kernel_check import (
        CE_LOSS_TOL, CE_ROW_TOL, CE_SHAPES, ce_check, ce_inputs, ce_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    errors = {}
    for shape in CE_SHAPES:
        n, v, dtype, z, eps, pad = shape
        try:
            r = ce_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused launch or a fault in the run
            fail(f'fused_ce at N={n} V={v} {dtype}: {e}')
        ok = ce_ok(r, dtype)
        say('ce-kernels', ok=ok, shape=f'{n}x{v}', dtype=str(dtype)[6:],
            z=z, eps=eps, pad=pad, loss_err=f'{r["loss_err"]:.3e}',
            lse_err=f'{r["lse_err"]:.3e}', tol=CE_LOSS_TOL,
            dx_row_err=f'{r["dx_row_err"]:.3e}', dx_tol=CE_ROW_TOL[dtype],
            canary=r['canary'], finite=r['finite'])
        if not ok:
            fail(f'fused_ce disagrees with its plain version at {shape}: '
                 f'{r}')
        errors[shape] = r
        torch.cuda.empty_cache()

    timed = {}
    for n, v, dtype, z, eps in CE_TIMED:
        # two copies of 537 MB, ten times the L2: every call reads x from
        # device memory, as the step's loss does
        inputs = []
        for _ in range(2):
            x, labels, g = ce_inputs(n, v, dtype, gen)
            labels = labels.clamp(0, v - 1)
            _, lse = ce_forward(x, labels, z, eps)
            inputs.append((x, labels, g, lse))
        fwd_ms = time_rotating_ms(
            lambda x, y, g, lse: ce_forward(x, y, z, eps), inputs, iters=20)
        bwd_ms = time_rotating_ms(
            lambda x, y, g, lse: ce_backward(x, y, lse, g, z, eps), inputs,
            iters=20)
        plain_fwd = time_rotating_ms(
            lambda x, y, g, lse: reference_ce_fwd(x, y, z, eps), inputs,
            iters=4)
        plain_bwd = time_rotating_ms(
            lambda x, y, g, lse: reference_ce_bwd(x, y, lse, g, z, eps),
            inputs, iters=4)
        lib_fwd = time_rotating_ms(
            lambda x, y, g, lse: library_ce(x, y.long(), z, eps), inputs,
            iters=10)
        graphs = []
        for x, y, g, lse in inputs:
            leaf = x.detach().requires_grad_()
            graphs.append((leaf, library_ce(leaf, y.long(), z, eps), g))
        lib_bwd = time_rotating_ms(
            lambda leaf, out, g: torch.autograd.grad(
                out, leaf, g.to(out.dtype), retain_graph=True),
            graphs, iters=10)
        bounds = {k: ce_bound_ms(n, v, dtype, k == 'bwd')
                  for k in ('fwd', 'bwd')}
        timed[n] = {'fwd': dict(ms=fwd_ms, plain_ms=plain_fwd,
                                library_ms=lib_fwd, bound_ms=bounds['fwd'][0],
                                bound_by=bounds['fwd'][1]),
                    'bwd': dict(ms=bwd_ms, plain_ms=plain_bwd,
                                library_ms=lib_bwd, bound_ms=bounds['bwd'][0],
                                bound_by=bounds['bwd'][1])}
        for k, t in timed[n].items():
            say('ce-kernels', kernel=k, shape=f'{n}x{v}',
                dtype=str(dtype)[6:], z=z, eps=eps, ms=f'{t["ms"]:.4f}',
                bound_ms=f'{t["bound_ms"]:.4f}', bound_by=t['bound_by'],
                bound_share=f'{t["bound_ms"] / t["ms"]:.3f}',
                plain_ms=f'{t["plain_ms"]:.3f}',
                library_ms=f'{t["library_ms"]:.4f}',
                gbytes_per_s=f'{(2 if k == "bwd" else 1) * n * v * 2 / t["ms"] / 1e6:.1f}')
        del inputs, graphs
        torch.cuda.empty_cache()
    step_n, step_v = CE_TIMED[0][:2]
    err = errors[(*CE_TIMED[0], 0)]
    library = ('F.cross_entropy(x, y, reduction="none", label_smoothing=eps)'
               ' + z * logsumexp(x)^2')
    entries = []
    for k, name, line in (('fwd', 'fused_ce_fwd', 79),
                          ('bwd', 'fused_ce_bwd', 124)):
        entries.append({
            'name': name, 'route': 'cuda',
            'source': 'mlcomp_tpu_torch/csrc/fused_ce.cu',
            'replaces': f'mlcomp_tpu/ops/fused_ce.py:{line}',
            'max_abs_err': err['loss_err'] if k == 'fwd'
            else err['max_abs_err'],
            **timed[step_n][k], 'shape': [step_n, step_v, 'bfloat16'],
            'library': library if k == 'fwd' else f'autograd of {library}',
            'shapes': {f'{n}x{step_v}': timed[n][k] for n in timed}})
    return entries


# ------------------------------------------------------- the wide int8 LM
#: ``bench_lm``'s wide legs (bench.py:636-687): the flagship at d_model
#: 2048, 32 heads of 64, d_ff 8192 — 687,900,672 parameters
WIDE = {**FLAGSHIP, 'd_model': 2048, 'n_heads': 32, 'd_ff': 8192}
WIDE_INT8 = {**WIDE, 'matmul_precision': 'int8', 'param_dtype': 'bfloat16'}
#: the fused-CE loss as a JAX config writes it
FUSED_CE_LOSS = {'name': 'lm_ce', 'impl': 'pallas', 'z_loss': 1e-4,
                 'label_smoothing': 0.1}
#: rows of 8192 random tokens in the wide phase's npz: 2 train, 1 valid
WIDE_ROWS = 3
WIDE_STEP_ITERS = 3
#: (c) against (d) on the same logits: the kernels' loss and logits
#: gradient against the dense formulation (f32 sums in another order;
#: the gradient rounds to bf16 on both sides)
MIN_CE_GRAD_COSINE = 0.9999
MAX_CE_LOSS_REL = 1e-3
#: (a) bf16 against (b) int8 with bf16 masters from the same weights:
#: the least cosine of any parameter's gradient. STE int8 gradients
#: round each product's operands to a 127th of their channel's absmax
#: (and the bf16 masters round the weights): measured 0.9926 on the H100
#: (the MLP's wi_gate weights; mean 0.995). A cosine does not see a
#: gradient's scale: ``[int8-train]`` holds the product's gradients
#: against the STE oracle by relative norm
MIN_INT8_GRAD_COSINE = 0.98


def phase_int8_train_matmul(seed: int):
    """``int8_train_matmul`` forward and gradients against the STE
    oracle at the wide step's shapes (``kernel_check``'s bounds)."""
    from mlcomp_tpu_torch.testing.kernel_check import (
        INT8_TRAIN_SHAPES, INT8_TRAIN_TOL, int8_train_check, int8_train_ok,
    )
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for shape in INT8_TRAIN_SHAPES:
        try:
            r = int8_train_check(shape, gen)
            torch.cuda.synchronize()
        except Exception as e:  # a refused call or a fault in the run
            fail(f'int8_train_matmul at {shape}: {e}')
        ok = int8_train_ok(r)
        say('int8-train', ok=ok, shape='x'.join(map(str, shape[:3])),
            weight=str(shape[3])[6:],
            **{f'{k}_rel_err': f'{r[k]:.3e}' for k in INT8_TRAIN_TOL},
            tol=INT8_TRAIN_TOL)
        if not ok:
            fail(f'int8_train_matmul disagrees with its STE oracle at '
                 f'{shape}: {r}')
        torch.cuda.empty_cache()


def phase_train_wide_int8(seed: int) -> dict:
    """The training entry point on the wide LM with int8 training
    matmuls, bf16 masters and the fused-CE loss; returns the launches of
    each kernel in its run."""
    import gc
    from mlcomp_tpu_torch.ops import flash_attention as fa
    from mlcomp_tpu_torch.ops import fused_ce
    from mlcomp_tpu_torch.ops.int8_matmul import int8_matmul
    from mlcomp_tpu_torch.train.export import make_predictor
    from mlcomp_tpu_torch.worker.executors import Executor

    t, vocab = WIDE['max_seq_len'], WIDE['vocab_size']
    work = tempfile.mkdtemp(prefix='mlcomp_smoke_wide_')
    cwd = os.getcwd()
    try:
        tokens = np.random.default_rng(seed + 3).integers(
            0, vocab, (WIDE_ROWS, t), dtype=np.int32)
        data = os.path.join(work, 'tokens.npz')
        np.savez(data, x=tokens, y=tokens)
        ck_dir = os.path.join(work, 'checkpoints')
        config = {'executors': {'train': {
            'type': 'train', 'model': dict(WIDE_INT8),
            'dataset': {'name': 'npz', 'path': data},
            'loss': dict(FUSED_CE_LOSS), 'batch_size': 1,
            'stages': [{'name': 'stage1', 'epochs': 1, 'optimizer': {
                'name': 'adamw', 'lr': 3e-4, 'master_dtype': 'bfloat16',
                'schedule': {'name': 'warmup_cosine'}}}],
            'main_metric': 'loss', 'minimize': True,
            'checkpoint_dir': ck_dir, 'model_name': 'wide_lm_int8',
            'seed': seed, 'device': 'cuda'}}}
        os.chdir(work)
        executor = Executor.from_config('train', config)
        n_train = int(WIDE_ROWS * 0.8)
        n_valid = WIDE_ROWS - n_train
        counters = {'flash_attention_fwd': fa.flash_attention_forward,
                    'flash_attention_bwd_dq': fa.flash_attention_backward_dq,
                    'flash_attention_bwd_dkv':
                        fa.flash_attention_backward_dkv,
                    'fused_ce_fwd': fused_ce.ce_forward,
                    'fused_ce_bwd': fused_ce.ce_backward,
                    'int8_matmul': int8_matmul}
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        result = executor(logger=_train_logger())
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        layers = WIDE['n_layers']
        # the eval step's loss runs the CE forward too
        want = {'flash_attention_fwd': layers * (n_train + n_valid),
                'flash_attention_bwd_dq': layers * n_train,
                'flash_attention_bwd_dkv': layers * n_train,
                'fused_ce_fwd': n_train + n_valid,
                'fused_ce_bwd': n_train, 'int8_matmul': 0}
        files = sorted(os.listdir(ck_dir))
        export = os.path.join(work, 'models', 'wide_lm_int8')
        say('train-wide-int8', steps=n_train, valid_rows=n_valid,
            seconds=f'{train_s:.1f}', valid_loss=result['best_score'],
            params=result['n_params'], launches=launches,
            checkpoints=files)
        if launches != want:
            fail(f'expected launches {want} (per step 1 CE forward and 1 '
                 f'backward, 8 flash forwards and 8 of each backward; 1 CE '
                 f'forward and 8 flash forwards per valid batch; no '
                 f'serving int8 launch), got {launches}')
        if not np.isfinite(result['best_score']):
            fail(f'train loss is not finite: {result}')
        if not {'best.msgpack', 'last.msgpack'} <= set(files) \
                or not os.path.exists(export + '.msgpack'):
            fail(f'checkpoints {files} or the export {export} missing')
        predict = make_predictor(export, batch_size=1, activation='argmax',
                                 device='cuda')
        weight = predict.model.layers[0].mlp.wo.weight
        y = predict(tokens[:1])
        ok = (y.shape == (1, t) and 0 <= y.min() and y.max() < vocab
              and weight.dtype == torch.bfloat16
              and type(predict.model.layers[0].mlp.wo).__name__
              == 'Int8DenseGeneral')
        say('train-wide-int8', export=os.path.basename(export),
            param_dtype=str(weight.dtype)[6:],
            projection=type(predict.model.layers[0].mlp.wo).__name__,
            predict_shape=y.shape, ok=ok)
        if not ok:
            fail(f'the int8-trained export predicts {y.shape} {y.dtype} '
                 f'with {weight.dtype} weights')
        del predict, weight
        return launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _cosine(a, b) -> float:
    import torch.nn.functional as F
    return float(F.cosine_similarity(a.flatten().float(),
                                     b.flatten().float(), dim=0))


def phase_step_wide(seed: int) -> dict:
    """``bench_lm``'s wide legs at B=1, T=8192 on the same weights: (a)
    bf16 matmuls, f32 params, ``lm_ce``; (b) int8 matmuls with bf16
    masters, ``lm_ce`` (``lm_wide_int8_vs_bf16``); (c) the same with the
    fused-CE kernels, z-loss and smoothing; (d) that loss dense. Checks
    (c) against (d) and (a) against (b), times the four in turns and
    splits (c)'s step with the profiler. Returns its numbers."""
    import gc
    from mlcomp_tpu_torch.models import create_model, param_count
    from mlcomp_tpu_torch.ops.fused_ce import reference_ce
    from mlcomp_tpu_torch.ops.int8_matmul import _quantize_rows
    from mlcomp_tpu_torch.train.loop import (
        create_train_state, loss_for_task, make_train_step,
    )
    from mlcomp_tpu_torch.train.optim import make_optimizer

    t, vocab = WIDE['max_seq_len'], WIDE['vocab_size']
    layers, d, ff = WIDE['n_layers'], WIDE['d_model'], WIDE['d_ff']
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (1, t)).astype(np.int32)).cuda()
    bf16 = create_model(**WIDE, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(seed))
    int8 = create_model(**WIDE_INT8, device='cuda')
    int8.load_state_dict(bf16.state_dict())
    n_params = param_count(bf16)
    losses = {'lm_ce': loss_for_task('lm_ce'),
              'kernel': loss_for_task({**FUSED_CE_LOSS, 'impl': 'cuda'}),
              'dense': loss_for_task({**FUSED_CE_LOSS, 'impl': 'dense'})}

    def grads(model):
        loss, _ = losses['lm_ce'](model(tokens, train=True), tokens)
        return dict(zip((n for n, _ in model.named_parameters()),
                        torch.autograd.grad(loss, list(model.parameters()))))

    # (a) against (b): every parameter's gradient from the same weights
    ga = grads(bf16)
    gb = grads(int8)
    cosines = {n: _cosine(ga[n], gb[n]) for n in ga}
    worst = min(cosines, key=cosines.get)
    del ga, gb
    # (c) against (d): the loss and its gradient on the same logits
    logits = int8(tokens, train=True).detach()
    ce = {}
    for impl in ('kernel', 'dense'):
        leaf = logits.clone().requires_grad_()
        loss, _ = losses[impl](leaf, tokens)
        ce[impl] = (float(loss.detach()), torch.autograd.grad(loss, leaf)[0])
    ce_cos = _cosine(ce['kernel'][1], ce['dense'][1])
    ce_rel = abs(ce['kernel'][0] - ce['dense'][0]) / abs(ce['dense'][0])
    say('step-wide', params=n_params, grad_min_cosine_int8_vs_bf16=
        f'{cosines[worst]:.6f}', worst=worst,
        mean_cosine=f'{sum(cosines.values()) / len(cosines):.6f}',
        bound=MIN_INT8_GRAD_COSINE, ce_logits_grad_cosine=f'{ce_cos:.7f}',
        ce_cos_bound=MIN_CE_GRAD_COSINE, ce_loss_kernel=f'{ce["kernel"][0]:.6f}',
        ce_loss_dense=f'{ce["dense"][0]:.6f}', ce_loss_rel=f'{ce_rel:.2e}',
        ce_loss_bound=MAX_CE_LOSS_REL)
    for n in sorted(cosines, key=cosines.get)[:4]:
        say('step-wide-grad', tensor=n, cosine=f'{cosines[n]:.6f}')
    del logits, ce
    gc.collect()
    torch.cuda.empty_cache()
    if not cosines[worst] >= MIN_INT8_GRAD_COSINE:
        fail(f'int8 gradients disagree with bf16: {worst} cosine '
             f'{cosines[worst]}')
    if not (ce_cos >= MIN_CE_GRAD_COSINE and ce_rel <= MAX_CE_LOSS_REL):
        fail(f'the fused CE disagrees with the dense CE on the step: '
             f'cosine {ce_cos}, loss relative difference {ce_rel}')

    opt_a, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4}, 1000)
    opt_i, _ = make_optimizer({'name': 'adamw', 'lr': 3e-4,
                               'master_dtype': 'bfloat16'}, 1000)
    state_a = create_train_state(bf16, opt_a, seed=seed)
    state_i = create_train_state(int8, opt_i, seed=seed)
    variants = {
        'a_bf16': (state_a, make_train_step(bf16, opt_a, losses['lm_ce'],
                                            self_supervised=True)),
        'b_int8': (state_i, make_train_step(int8, opt_i, losses['lm_ce'],
                                            self_supervised=True)),
        'c_int8_fused_ce': (state_i, make_train_step(
            int8, opt_i, losses['kernel'], self_supervised=True)),
        'd_int8_dense_ce': (state_i, make_train_step(
            int8, opt_i, losses['dense'], self_supervised=True)),
    }
    for state, step in variants.values():
        for _ in range(2):                   # warm-up
            step(state, tokens, None)
    times = {k: [] for k in variants}
    for _ in range(2):                       # in turns: a b c d a b c d
        for name, (state, step) in variants.items():
            times[name].append(time_ms(lambda: step(state, tokens, None),
                                       iters=WIDE_STEP_ITERS, warmup=0))
    flops_per_token = 6 * n_params + 6 * layers * t * d
    out = {}
    for name, ts in times.items():
        ms = min(ts)
        tok_s = t / (ms / 1e3)
        out[name] = {'step_ms': ms, 'step_ms_all': ts, 'tokens_per_s': tok_s,
                     'mfu': tok_s * flops_per_token
                     / PEAK_OPS_PER_S[torch.bfloat16]}
        say('step-wide', variant=name, step_ms=f'{ms:.2f}',
            runs=[f'{x:.2f}' for x in ts], tokens_per_s=f'{tok_s:.1f}',
            mfu=f'{out[name]["mfu"]:.4f}')
    out['lm_wide_int8_vs_bf16'] = (out['b_int8']['tokens_per_s']
                                   / out['a_bf16']['tokens_per_s'])
    loss = float(variants['c_int8_fused_ce'][1](state_i, tokens,
                                                None)[1]['loss'])
    if not np.isfinite(loss):
        fail(f'the wide int8 step loss is not finite: {loss}')

    # where (c)'s step goes: the CE kernels, the int8 GEMMs (profiler)
    state, step = variants['c_int8_fused_ce']
    fields = {}
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(state, tokens, None)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        events = prof.events()
        kernels = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and not getattr(
                    e, 'is_user_annotation', False):
                kernels[e.name] = kernels.get(e.name, 0.0) \
                    + e.device_time_total
        total_us = sum(kernels.values())
        if total_us <= 0:
            raise RuntimeError('the profile holds no device time')
        ce_us = sum(us for name, us in kernels.items()
                    if 'ce_fwd_kernel' in name or 'ce_bwd_kernel' in name)
        # the kernels each aten::_int_mm call launched
        int_mm_us = sum(e.device_time_total for e in events
                        if e.name == 'aten::_int_mm'
                        and e.device_type == DeviceType.CPU)
        by_name = sorted(((us, name) for name, us in kernels.items()),
                         reverse=True)
        for us, name in by_name[:TOP_KERNELS]:
            say('step-wide-kernel', ms_per_step=f'{us / 2e3:.3f}',
                share=f'{us / total_us:.4f}', name=repr(name[:90]))
        fields.update(device_ms=total_us / 2e3, ce_kernels_ms=ce_us / 2e3,
                      int_mm_ms=int_mm_us / 2e3,
                      device_busy=total_us / 2e3
                      / out['c_int8_fused_ce']['step_ms'])
    except Exception as e:      # a profiler that reads no device time
        fields.update(device_ms='not measured', profiler=repr(str(e)[:80]))

    # the quantize passes of one step (CUDA events at the step's shapes:
    # per layer x of qkv, wi_gate, wi_up and out [T, d], of wo [T, ff];
    # the five weights), the dense CE's forward and backward, and the two
    # [N, V] passes around the kernels: the accuracy's f32 argmax and
    # the slice's gradient padded back to [B, T, V]
    x_d = torch.randn((t, d), device='cuda').to(torch.bfloat16)
    x_f = torch.randn((t, ff), device='cuda').to(torch.bfloat16)
    q_ms = layers * (4 * time_ms(lambda: _quantize_rows(x_d), iters=10)
                     + time_ms(lambda: _quantize_rows(x_f), iters=10))
    w_ms = 0.0
    for name, p in int8.named_parameters():
        if p.dim() == 2 and 'layers.' in name:
            w_ms += time_ms(lambda: _quantize_rows(p.detach()), iters=10)
    logits = torch.randn((1, t, vocab), device='cuda').to(torch.bfloat16)
    lg = logits[:, :-1]
    labels = tokens[:, 1:].reshape(-1).long()

    def dense_ce():
        leaf = lg.reshape(-1, vocab).detach().requires_grad_()
        loss = reference_ce(leaf, labels, 1e-4, 0.1).mean()
        torch.autograd.grad(loss, leaf)

    dense_ce_ms = time_ms(dense_ce, iters=5)
    argmax_ms = time_ms(lambda: lg.float().argmax(-1), iters=5)
    grad = torch.empty((1, t - 1, vocab), device='cuda',
                       dtype=torch.bfloat16)

    def pad_grad():
        full = torch.zeros_like(logits)
        full[:, :-1].copy_(grad)

    pad_ms = time_ms(pad_grad, iters=5)
    fields.update(quantize_x_ms=q_ms, quantize_w_ms=w_ms,
                  dense_ce_fwd_bwd_ms=dense_ce_ms, argmax_f32_ms=argmax_ms,
                  slice_grad_pad_ms=pad_ms)
    say('step-wide-split', **{k: (f'{v:.3f}' if isinstance(v, float) else v)
                              for k, v in fields.items()})
    out['split'] = fields
    out['checks'] = {'grad_min_cosine_int8_vs_bf16': cosines[worst],
                     'worst': worst, 'ce_logits_grad_cosine': ce_cos,
                     'ce_loss_rel': ce_rel}
    say('step-wide', lm_wide_int8_vs_bf16=f'{out["lm_wide_int8_vs_bf16"]:.3f}',
        fused_vs_dense_ce=f'{out["d_int8_dense_ce"]["step_ms"] / out["c_int8_fused_ce"]["step_ms"]:.3f}',
        loss=f'{loss:.4f}')
    del variants, state_a, state_i, state, step, bf16, int8, logits, lg, grad
    del x_d, x_f
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false — this smoke run needs '
             'an NVIDIA card')
    # a fresh root (its models/ folder) for the export, set before the
    # package computes MODEL_FOLDER at import
    root = tempfile.mkdtemp(prefix='mlcomp_smoke_')
    os.environ['MLCOMP_TPU_ROOT'] = root
    try:
        try:
            import mlcomp_tpu_torch  # noqa: F401
        except ImportError as e:
            fail(f'the mlcomp_tpu_torch package is not beside this '
                 f'script: {e}')
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
        torch.backends.cudnn.allow_tf32 = False

        smi = phase_device()
        phase_build()
        fwd = phase_kernels(args.seed)
        backward = phase_backward_kernels(args.seed)
        norm = phase_norm_kernel(args.seed)
        int8 = phase_int8_kernel(args.seed)
        stack = phase_stack_kernel(args.seed)
        ce = phase_ce_kernels(args.seed)
        phase_int8_train_matmul(args.seed)
        serve_launches = phase_serving(args.seed)
        int8_serve, int8_split = phase_serve_int8(args.seed)
        leg = phase_serving_int8(args.seed)
        train_launches = phase_train(args.seed)
        wide_launches = phase_train_wide_int8(args.seed)
        norm['launches'] = phase_cifar_train(args.seed)
        # a profiler window can leave CUDA tracing on, which slows later
        # launches from the host: the step phases, which profile, come
        # last, and the launch-bound ResNet step before the LM's
        step_norm_ms = phase_cifar_step(args.seed)
        phase_step(args.seed)
        step_wide = phase_step_wide(args.seed)
        norm['device_ms'] = profile_norm_sites(args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fwd['launches_by_path'] = {
        'serve': serve_launches,
        'train': train_launches['flash_attention_fwd'],
        'train_wide_int8': wide_launches['flash_attention_fwd']}
    fwd['launches'] = sum(fwd['launches_by_path'].values())
    for entry in backward:
        entry['launches_by_path'] = {
            'train': train_launches[entry['name']],
            'train_wide_int8': wide_launches[entry['name']]}
        entry['launches'] = sum(entry['launches_by_path'].values())
    for entry in ce:
        entry['launches_by_path'] = {
            'train_wide_int8': wide_launches[entry['name']]}
        entry['launches'] = wide_launches[entry['name']]
    ce[0]['step_wide'] = step_wide
    # the 20 norm sites of a batch-512 train step as the profiler reads
    # them (absent if it read no device time)
    norm['step_device_ms'] = step_norm_ms.get('fused')
    int8['launches_by_path'] = {
        'serve_int8_per_layer': int8_serve['flagship_lm_layers'],
        'serve_int8_stacked': int8_serve['flagship_lm'],
        'serving_int8': leg['launches']['int8_matmul']}
    int8['launches'] = sum(int8['launches_by_path'].values())
    int8['dispatch_split'] = int8_split
    stack['launches_by_path'] = {
        'serving_int8': leg['launches']['serving_stack']}
    stack['launches'] = sum(stack['launches_by_path'].values())
    stack['serving_int8'] = leg['numbers']
    kernels = [fwd] + backward + [norm, int8, stack] + ce
    for entry in kernels:
        if entry['launches'] <= 0:
            fail(f'the main path launched no {entry["name"]}')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

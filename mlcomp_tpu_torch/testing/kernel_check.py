"""How the card-side checks hold the kernels against their plain
versions (``chip_smoke.py`` and ``kernel_faults``): the attention
kernels first, then the fused batch-norm+ReLU ("Fused norm"), then the
weight-only int8 matmul and the serving stack ("Int8 serving"), the
int8 training product, a library call held against its STE oracle by
relative norm ("int8 training"), then the blocked softmax cross-entropy
("Cross-entropy").

The measure is the relative L2 error of each output row (one query
position of one head, D values), ``|out - ref| / |ref|``, its maximum
over all rows. A bound scaled to the tensor's largest values would be
loose where it matters: with random q, k and v a causal row i averages
about i values of v, so ``|out|`` shrinks like ``1/sqrt(i)`` and a row
deep in an 8192-token sequence is ~90x smaller than row 0. A fault that
only touches deep rows (a K/V tile skipped there) moves them by ~10% of
their own size, far below an elementwise bound of ``tol * (1 + |ref|)``;
per row it reads as 10%.

``ref`` is ``reference_attention(..., round_p=True)``: P rounded to v's
dtype as the kernel rounds it, so what remains is the kernel's running
max (its P is rounded against the max so far, not the row's), its
summation order and the output's final rounding.
"""

import math

import torch

#: (B, T, H, D, dtype, causal) at which the card-side checks hold the
#: kernel against its plain version: the flagship LM's serving shape
#: first (batch 4, T=8192, 16 heads of 64, causal, bf16), the long-context
#: leg of ``bench.py``'s ``bench_lm`` (batch 1, T=32768, 8 heads of 64:
#: d_model 512), the wide LM's training shape (batch 1, T=8192, 32 heads
#: of 64: q, k, v rows 3·32·64 apart), then long sequences causal and
#: not, ragged T, every head dim, fp16, f32 (the SIMT path), T=1 and a T
#: just past one K/V tile
ATTENTION_SHAPES = [
    (4, 8192, 16, 64, torch.bfloat16, True),
    (1, 32768, 8, 64, torch.bfloat16, True),
    (1, 8192, 32, 64, torch.bfloat16, True),
    (1, 8192, 16, 64, torch.bfloat16, True),
    (1, 8192, 16, 64, torch.bfloat16, False),
    (2, 1000, 16, 64, torch.bfloat16, True),
    (1, 2048, 8, 128, torch.bfloat16, True),
    (1, 777, 4, 32, torch.bfloat16, False),
    (1, 1024, 8, 64, torch.float16, True),
    (1, 300, 4, 64, torch.float32, True),
    (1, 129, 2, 128, torch.float32, False),
    (3, 1, 2, 64, torch.bfloat16, True),
    (1, 65, 3, 32, torch.float16, False),
]
#: bound on the max over rows of |out - ref| / |ref|, by input dtype; a
#: few ulps of the output's rounding (bf16 2^-8, fp16 2^-11 relative),
#: f32 only the summation order and the exponentials' last bits
ATTENTION_ROW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3,
                     torch.float32: 1e-5}


#: (B, T, H, D, dtype, causal) at which the card-side checks hold the
#: backward kernels (and the forward's lse) against their plain versions:
#: the flagship LM's training shape first (batch 1, T=8192, 16 heads of
#: 64, causal, bf16), the wide LM's (32 heads of 64), then non-causal,
#: ragged T, every head dim, fp16, f32 (the SIMT path, both head-dim
#: extremes) and T=1
BACKWARD_SHAPES = [
    (1, 8192, 16, 64, torch.bfloat16, True),
    (1, 8192, 32, 64, torch.bfloat16, True),
    (1, 8192, 16, 64, torch.bfloat16, False),
    (2, 1000, 16, 64, torch.bfloat16, True),
    (1, 2048, 8, 128, torch.bfloat16, True),
    (1, 777, 4, 32, torch.bfloat16, False),
    (1, 1024, 8, 64, torch.float16, True),
    (1, 300, 4, 64, torch.float32, True),
    (1, 129, 2, 128, torch.float32, False),
    (3, 1, 2, 64, torch.bfloat16, True),
]
#: bound on the row error of dq, dk and dv against
#: ``reference_attention_backward`` (the kernels' own numerics: P and dS
#: rounded to the input dtype, outputs rounded to it), by input dtype
BACKWARD_ROW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3,
                    torch.float32: 1e-5}
#: bound on the error of each head's whole dq, dk and dv ([T, D], L2)
#: against the same plain version: flips of single roundings average
#: out over a head, a change of the numerics (dS not rounded) does not
BACKWARD_HEAD_TOL = {torch.bfloat16: 1e-3, torch.float16: 2e-4,
                     torch.float32: 1e-6}
#: bound on the error of each head's whole dq, dk and dv ([T, D], L2)
#: against torch autograd through the plain ``reference_attention`` (no
#: rounding of P or dS), by input dtype: what the rounding the TPU
#: kernels chose costs. Per head, not per row: a query that sees two
#: keys has dS = (x, -x) exactly, and the rounding of x can move its dq
#: row by a large share of its own small size
AUTOGRAD_HEAD_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                     torch.float32: 1e-5}
#: the backward's rows are measured against at least this share of the
#: rms row size: query 0 of a causal head sees one key, so its exact dq
#: is 0 and the computed one rounding noise
BACKWARD_ROW_FLOOR = 1e-2
#: bound on |lse - ref| / max(1, |ref|): an absolute error of the lse is
#: the relative error of every probability rebuilt from it
LSE_TOL = 1e-5


# ------------------------------------------------------------ fused norm
#: the CIFAR ResNet-18's norm sites of one train forward by stage (stem
#: and stage 1, then stages 2-4): (sites with the ReLU, sites without)
CIFAR_SITE_ACTS = [(3, 2), (2, 3), (2, 3), (2, 3)]


def cifar_norm_sites(batch: int) -> list:
    """[(R, C)] of the CIFAR ResNet-18's norm sites by stage at
    ``batch``: 32x32 with 64 channels, each later stage half the side and
    twice the channels (R = batch·H·W)."""
    return [(batch * 1024 >> 2 * i, 64 << i) for i in range(4)]


#: (R, C, dtype, act) at which the card-side checks hold the fused norm
#: kernel against ``reference_norm_act``: the CIFAR ResNet-18's sites at
#: batch 512 (the step's) and 256 (the executor's; another row split),
#: each with and without the ReLU, then ragged rows and channels (tails
#: of the 8-channel vectors, a single row, one row block) in fp16 with
#: the ReLU and f32 without
NORM_SHAPES = [(r, c, torch.bfloat16, act) for batch in (512, 256)
               for r, c in cifar_norm_sites(batch)
               for act in (True, False)] + [
    (r, c, dtype, act)
    for dtype, act in ((torch.float16, True), (torch.float32, False))
    for r in (1, 8, 777, 1000) for c in (3, 100, 1000)]
#: bound on the relative L2 error of each channel of y ([R] values)
#: against the plain version, by dtype: a few roundings of y (bf16 2^-8,
#: fp16 2^-11 relative); f32 only the summation order of the statistics.
#: The plain version runs in f64 (y rounded to x's dtype): in f32 its
#: own E[x²] − mean² loses ~1e-5 of y at R=8 when the mean is large
#: against the spread, as much as the bound
NORM_Y_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3,
              torch.float32: 1e-5}
#: bound on |mean - ref| / sqrt(E[x²]) and |var - ref| / E[x²] per
#: channel: the kernel sums x − k and (x − k)² in f32 within a row
#: block (k the channel's first row)
NORM_STAT_TOL = 1e-5
#: channels of y are measured against at least this share of the rms
#: channel (a channel that the ReLU zeroes holds only rounding noise)
NORM_COLUMN_FLOOR = 1e-2


def norm_inputs(r, c, dtype, gen, device='cuda'):
    """x [R, C] with a mean of 0.5-2 and a spread of 0.5-1.5 per channel
    (a variance that forgets the mean² term is then far off), gamma in
    [0.5, 1.5), beta normal(0, 0.5), from ``gen``."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)
    mean, spread = rand(c) * 1.5 + 0.5, rand(c) + 0.5
    x = torch.randn((r, c), generator=gen, device=device) * spread + mean
    gamma = rand(c) + 0.5
    beta = torch.randn((c,), generator=gen, device=device) * 0.5
    return x.to(dtype), gamma, beta


def norm_check(shape, gen, device='cuda') -> dict:
    """The fused norm kernel once at ``shape`` (as ``NORM_SHAPES`` lists
    them) on inputs from ``gen`` against the plain version in f64: the
    mean and var errors (scaled by the channel's E[x²]), the worst
    channel's relative error of y (the reference's y rounded to x's
    dtype), y's largest absolute error, and whether everything is
    finite."""
    from mlcomp_tpu_torch.ops import fused_norm
    r, c, dtype, act = shape
    x, gamma, beta = norm_inputs(r, c, dtype, gen, device)
    y, mean, var = fused_norm.norm_act_forward(x, gamma, beta, act=act)
    ry, rmean, rvar = fused_norm.reference_norm_act(
        x.double(), gamma.double(), beta.double(), act=act)
    ry = ry.to(dtype)
    ex2 = x.double().square().mean(dim=0)
    least = NORM_COLUMN_FLOOR * _rms_row(ry.t())
    return {
        'mean_err': float(((mean - rmean).abs() / ex2.sqrt()).max()),
        'var_err': float(((var - rvar).abs() / ex2).max()),
        'y_err': row_relative_error(y.t(), ry.t(), least),
        'max_abs_err': float((y.float() - ry.float()).abs().max()),
        'finite': all(bool(torch.isfinite(t).all()) for t in (y, mean, var)),
    }


def norm_ok(result: dict, dtype) -> bool:
    """Every bound of ``norm_check``'s result holds."""
    return (result['finite'] and result['mean_err'] <= NORM_STAT_TOL
            and result['var_err'] <= NORM_STAT_TOL
            and result['y_err'] <= NORM_Y_TOL[dtype])


# ---------------------------------------------------------- int8 serving
#: (M, K, N) at which the card-side checks hold the int8 matmul kernel
#: against its plain version run in f64: the bench's weight-bound shape
#: (K split over the SMs), the served flagship LM's projections and its
#: head at batch 4 (M = 4·8192), then ragged shapes: K not a multiple of
#: 16 (zero-padded for TMA) with a split (5×1000×999), one row and one K
#: tile (1×64×10), M and N tails without a split (200×64×1000), and a
#: split K with an N tail (37×4096×1000); then the wgmma tiles' edges: M
#: one past the small configuration's 64 tokens (65), past the large
#: one's 128 and 256 (129, 257), N off the 128- and 256-channel tiles
#: and off whole 4-column stores (1000, 1090), K padded on the large
#: path (129×1000×1000) and K = 8192 summed whole at large M
INT8_SHAPES = [(64, 8192, 8192), (32768, 1024, 4096), (32768, 4096, 1024),
               (32768, 1024, 32768), (5, 1000, 999), (1, 64, 10),
               (200, 64, 1000), (37, 4096, 1000), (65, 1024, 4096),
               (129, 1000, 1000), (257, 4096, 1090), (4096, 8192, 2048)]
#: (M, K, N) at which the card-side checks hold the fused Int8Dense
#: epilogue (bias added, bf16 / fp16 out) bit for bit against the
#: unfused formula: the served LM's d_ff projection, the split-K path,
#: and tails with scalar stores
INT8_EPILOGUE_SHAPES = [(32768, 1024, 4096), (64, 8192, 8192),
                        (257, 4096, 1090), (5, 1000, 999)]
#: bound on the max over rows of |out - ref| / |ref| against the f64
#: plain version: the products are exact (bf16 × int8 fits f32), so
#: only the f32 sums over K ≤ 8192 (and the scale's one rounding) round
INT8_ROW_TOL = 1e-5
#: output rows past M that a tile can reach (the largest tile height):
#: the check fills this many rows of NaN after the output and reads them
#: back, so a store past M or N is caught
CANARY_ROWS = 128

#: (L, M, K, weight dtype, feed) at which the card-side checks hold the
#: serving-stack kernel against ``reference_stack`` on the card: the
#: bench's 8 layers of 8192² at M = 64 in int8 and bf16, one layer (no
#: feed at all), bf16 layers without the feed, and small ragged cases
#: (M = 5; M = 7 with K = N = 1000, zero-padded for TMA); then the
#: cluster's K split: a width it does not divide (1040: ranks past K
#: idle), two token tiles (M = 100), and K = 16384, where each rank's
#: slice is two resident pieces
STACK_SHAPES = [(8, 64, 8192, torch.int8, True),
                (8, 64, 8192, torch.bfloat16, True),
                (1, 64, 8192, torch.int8, False),
                (3, 64, 1024, torch.bfloat16, False),
                (3, 5, 1024, torch.int8, True),
                (2, 7, 1000, torch.int8, True),
                (3, 64, 1040, torch.int8, True),
                (2, 100, 1024, torch.bfloat16, True),
                (1, 16, 16384, torch.int8, False)]
#: bounds on the serving stack's row errors:
#: - ``step``: each layer of the kernel against that layer in f64, fed
#:   the kernel's own previous output (through ``stack_feed``, which the
#:   kernel's feed matches bit for bit): the kernel's f32 sums alone;
#: - ``chain``: the kernel's L layers against ``reference_stack``'s. The
#:   two sum in another order (~4e-7 of a row at K = 8192), and the feed
#:   rounds to bf16 between layers, which amplifies that: an activation
#:   on a rounding edge rounds the other way, one bf16 ulp (2^-8) of
#:   itself, so a relative difference ε of y becomes about √(ε·2^-8) of
#:   the next x. Over 8 layers that climbs to the bf16 rounding level
#:   (4.9e-3 measured on the H100 at 8 × 8192²); 1e-2 is 2.5 ulps
STACK_ROW_TOL = {'step': 1e-5, 'chain': 1e-2}


def stack_tol(layers: int) -> float:
    """The bound on the end-to-end row error of an L-layer stack: one
    layer is its f32 sums alone."""
    return STACK_ROW_TOL['step' if layers == 1 else 'chain']


def int8_inputs(m, k, n, gen, device='cuda'):
    """x [M, K] bf16 standard normal and a [K, N] weight of std 0.02
    quantized on the device: (x, w_qt, scale)."""
    from mlcomp_tpu_torch.ops.int8_matmul import quantize_int8
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=device) * 0.02
    return (x, *quantize_int8(w))


def int8_check(shape, gen, device='cuda') -> dict:
    """The int8 matmul kernel once at ``shape`` (M, K, N) on inputs from
    ``gen`` against the plain version in f64: the row error, the largest
    absolute error, whether the output is finite, and whether the
    CANARY_ROWS rows after it still hold the NaN they were filled with."""
    from mlcomp_tpu_torch.ops.int8_matmul import int8_matmul
    m, k, n = shape
    x, w_qt, scale = int8_inputs(m, k, n, gen, device)
    buf = torch.full(((m + CANARY_ROWS) * n,), float('nan'), device=device)
    out = buf[:m * n].view(m, n)
    int8_matmul(x, w_qt, scale, impl='cuda', out=out)
    ref = (x.double() @ w_qt.double().t()) * scale.double()
    result = {
        'row_err': row_relative_error(out, ref),
        'max_abs_err': float((out.double() - ref).abs().max()),
        'finite': bool(torch.isfinite(out).all()),
        'canary': bool(torch.isnan(buf[m * n:]).all()),
    }
    del ref, buf, out
    return result


def int8_ok(result: dict) -> bool:
    return (result['finite'] and result['canary']
            and result['row_err'] <= INT8_ROW_TOL)


def int8_epilogue_check(shape, gen, device='cuda') -> dict:
    """The fused ``Int8Dense`` epilogue once at ``shape`` (M, K, N): for
    each (bias, output dtype) of (f32 bias, bf16), (none, bf16), (f32
    bias, fp16), the elements where the kernel's one launch differs in
    its bits from the f32 product followed by ``reference_epilogue`` (the
    bias added in f32, then the cast) — 0 when they are bit for bit
    equal. On the CPU both sides are the plain version."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_matmul, reference_epilogue,
    )
    m, k, n = shape
    x, w_qt, scale = int8_inputs(m, k, n, gen, device)
    bias = torch.randn((n,), generator=gen, device=device)
    y = int8_matmul(x, w_qt, scale)
    result = {}
    for b, dtype in ((bias, torch.bfloat16), (None, torch.bfloat16),
                     (bias, torch.float16)):
        fused = int8_matmul(x, w_qt, scale, bias=b, out_dtype=dtype)
        want = reference_epilogue(y, b, dtype)
        name = f'{"bias" if b is not None else "none"}_{str(dtype)[6:]}'
        result[name] = int((fused.view(torch.int16)
                            != want.view(torch.int16)).sum())
    return result


def int8_epilogue_ok(result: dict) -> bool:
    return all(v == 0 for v in result.values())


def stack_inputs(layers, m, k, wdtype, gen, device='cuda'):
    """x [M, K] bf16 standard normal and L weights [K, K] of std 0.02 as
    the bench makes them: int8 by ``quantize_stack`` (w, scales) or bf16
    transposed to [L, N, K] (w, None)."""
    from mlcomp_tpu_torch.ops.serving_stack import quantize_stack
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    ws = [torch.randn((k, k), generator=gen, device=device) * 0.02
          for _ in range(layers)]
    if wdtype == torch.int8:
        return (x, *quantize_stack(ws))
    return x, torch.stack([w.t().to(torch.bfloat16) for w in ws]), None


def stack_check(shape, gen, device='cuda') -> dict:
    """The serving-stack kernel at ``shape`` (as ``STACK_SHAPES`` lists
    them) against ``reference_stack`` on the same device: the row error
    of the whole chain, the largest row error of one layer (the kernel
    run over the first l layers against layer l in f64, fed the kernel's
    own output of l - 1 layers), the chain's largest absolute error and
    whether its output is finite."""
    from mlcomp_tpu_torch.ops.serving_stack import (
        reference_stack, serving_stack, stack_feed,
    )
    layers, m, k, wdtype, feed = shape
    x, w, scales = stack_inputs(layers, m, k, wdtype, gen, device)

    def first(n):
        return w[:n], None if scales is None else scales[:n]

    out = serving_stack(x, w, scales, feed=feed, block_n=k, block_k=k)
    ref = reference_stack(x, w, scales, feed=feed)
    step, prev = 0.0, None
    for n in range(1, layers + 1):
        y = out if n == layers else serving_stack(
            x, *first(n), feed=feed, block_n=k, block_k=k)
        x_n = x if prev is None else (
            stack_feed(prev) if feed else prev.to(torch.bfloat16))
        # one layer in f64: an f32 product's own rounding over K = 8192
        # (~3e-6 of a row on the card) would hide the kernel's
        want = x_n.to(torch.bfloat16).double() @ \
            w[n - 1].to(torch.bfloat16).double().t()
        if scales is not None:
            want = want * scales[n - 1].double()
        step = max(step, row_relative_error(y, want))
        prev = y
    return {'row_err': row_relative_error(out, ref), 'step_err': step,
            'max_abs_err': float((out - ref).abs().max()),
            'finite': bool(torch.isfinite(out).all())}


def stack_ok(result: dict, layers: int) -> bool:
    return (result['finite'] and result['step_err'] <= STACK_ROW_TOL['step']
            and result['row_err'] <= stack_tol(layers))


# ------------------------------------------------------------ int8 training
#: (M, K, N, weight dtype) at which the card-side checks hold
#: ``int8_train_matmul`` (``torch._int_mm`` on the card, no kernel of the
#: port's own) against its STE oracle: the wide LM's ``qkv`` in its
#: training step (T = 8192 tokens, d_model 2048, 3·32·64 outputs, bf16
#: masters) and its ``wo`` with f32 params, whose gradients stay f32
INT8_TRAIN_SHAPES = [(8192, 2048, 6144, torch.bfloat16),
                     (8192, 8192, 2048, torch.float32)]
#: bounds on the relative L2 error of y, dx and dw against
#: ``reference_int8_train_matmul`` run in f32:
#: - y: the int32 sums are exact and the scales apply once in f32, so
#:   only the oracle's f32 sums round (~1e-6);
#: - dx, dw: the backward rounds the scale-folded dy to bf16 (the
#:   compute dtype, as JAX does): ~1.6e-3 rms relative (half a bf16 ulp
#:   is 2^-8); a bf16 gradient is rounded once more on each side, 2.8e-3
#:   in all (2.6e-3 read on the CPU at 64×128×96, 1.7e-3 for an f32 dw).
#:   A gradient scaled 1% off reads 1e-2, which a cosine does not see
INT8_TRAIN_TOL = {'y': 1e-5, 'dx': 5e-3, 'dw': 5e-3}


def int8_train_check(shape, gen, device='cuda', fn=None) -> dict:
    """``fn`` (``int8_train_matmul`` by default, bf16 compute) at
    ``shape`` (as ``INT8_TRAIN_SHAPES`` lists them) on x bf16 standard
    normal, a weight of std 0.02 and dy standard normal from ``gen``,
    against autograd through the STE oracle in f32: the relative L2
    error of y, dx and dw and whether all are finite."""
    from mlcomp_tpu_torch.ops.int8_matmul import (
        int8_train_matmul, reference_int8_train_matmul,
    )
    m, k, n, wdtype = shape
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(wdtype)
    dy = torch.randn((m, n), generator=gen, device=device)
    outs = []
    for f, cd in ((fn or int8_train_matmul, torch.bfloat16),
                  (reference_int8_train_matmul, torch.float32)):
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        y = f(*leaves, cd)
        outs.append((y.detach(), *torch.autograd.grad(y, leaves, dy)))
    result = {name: float((got.float() - want.float()).norm()
                          / want.float().norm())
              for name, got, want in zip(('y', 'dx', 'dw'), *outs)}
    result['finite'] = all(bool(torch.isfinite(t).all()) for t in outs[0])
    return result


def int8_train_ok(result: dict) -> bool:
    """Every bound of ``int8_train_check``'s result holds (NaN fails)."""
    return result['finite'] and all(result[name] <= tol
                                    for name, tol in INT8_TRAIN_TOL.items())


# ----------------------------------------------------------- cross-entropy
#: (N, V, dtype, z_loss, label_smoothing, pad) at which the card-side
#: checks hold the CE kernels against their plain versions run in f64,
#: rows ``pad`` elements wider than V (a view into wider rows): the wide
#: LM's training step first (N = B(T-1) = 8191 at B = 1, T = 8192;
#: V = 32768; bf16) with every (z, ε) of {0, 1e-4} × {0, 0.1}, then
#: ``bench_fused_ce``'s 8192 × 32768, then ragged shapes in fp16 and f32
#: — one row; V = 50257, whose rows start off 16-byte boundaries; V = 127
#: and V = 1, below a vector — and rows read at a stride
CE_SHAPES = ([(8191, 32768, torch.bfloat16, z, e, 0)
              for z in (0.0, 1e-4) for e in (0.0, 0.1)]
             + [(8192, 32768, torch.bfloat16, 1e-4, 0.1, 0)]
             + [(n, v, dtype, 1e-4, 0.1, 0)
                for dtype in (torch.float16, torch.float32)
                for n, v in ((1, 32768), (7, 50257), (1000, 127), (300, 1))]
             + [(64, 1000, torch.float32, 1e-4, 0.1, 3),
                (33, 999, torch.bfloat16, 1e-4, 0.1, 5)])
#: the logits' scale: standard normal times this (an LM's logits spread
#: over a few units; the running max changes along a row)
CE_LOGIT_SCALE = 2.0
#: bound on max |loss - ref| and |lse - ref| against f64 (absolute: both
#: are ~10-20 at V = 32768, where one f32 ulp is ~1e-6). The kernel sums
#: exp in f32 in another order than f64 with ex2.approx (2^-22 relative
#: an element) and rounds m + log(s) and the loss's terms to f32: a few
#: 1e-6 in all; 2e-5 is the margin
CE_LOSS_TOL = 2e-5
#: bound on the max over rows of |dx - ref| / max(|ref|, |g|) against
#: the f64 plain version fed the kernel's own lse, by dtype: the output's
#: rounding (bf16 2^-9, fp16 2^-12 an element) and, in f32, ex2.approx.
#: A row is measured against |g| at least: dx's entries are O(g), and
#: where they nearly cancel (V = 1: dx = 2z·lse·g) f32 rounding of p·c1
#: against the target is all that is left
CE_ROW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3,
              torch.float32: 1e-5}
#: elements of NaN after loss, lse and dx that a store past the end would
#: overwrite (a row's unmasked tail reaches 7 past it)
CE_CANARY = 1024


def ce_inputs(n, v, dtype, gen, device='cuda', pad=0):
    """logits [N, V] (a view into rows of V + pad, CE_CANARY more values
    after them in the same buffer, so that a read past the last row stays
    inside it) of ``dtype``, labels [N] int64 in [-3, V + 3) — some out
    of range, as the wrappers clamp them — and the loss's gradient g [N]
    f32, all from ``gen``."""
    w = v + pad
    x = (torch.randn((n * w + CE_CANARY,), generator=gen, device=device)
         * CE_LOGIT_SCALE).to(dtype)[:n * w].view(n, w)[:, :v]
    labels = torch.randint(-3, v + 3, (n,), generator=gen, device=device)
    g = torch.randn((n,), generator=gen, device=device)
    return x, labels, g


def ce_check(shape, gen, device='cuda') -> dict:
    """Both CE kernels once at ``shape`` (as ``CE_SHAPES`` lists them)
    against their plain versions in f64 — the backward's fed the forward
    kernel's lse: the loss, lse and dx row errors, whether all are finite
    and whether the NaN canaries after each output are intact."""
    from mlcomp_tpu_torch.ops.fused_ce import (
        ce_backward, ce_forward, reference_ce_bwd, reference_ce_fwd,
    )
    n, v, dtype, z, eps, pad = shape
    x, labels, g = ce_inputs(n, v, dtype, gen, device, pad)
    bufs = [torch.full((n + CE_CANARY,), float('nan'), device=device)
            for _ in range(2)]
    loss, lse = (b[:n] for b in bufs)
    ce_forward(x, labels, z, eps, impl='cuda', out=(loss, lse))
    dx_buf = torch.full((n * v + CE_CANARY,), float('nan'), dtype=dtype,
                        device=device)
    dx = dx_buf[:n * v].view(n, v)
    ce_backward(x, labels, lse, g, z, eps, impl='cuda', out=dx)
    lab = labels.clamp(0, v - 1)
    ref_loss, ref_lse = reference_ce_fwd(x.double(), lab, z, eps)
    ref_dx = reference_ce_bwd(x.double(), lab, lse.double(), g.double(), z,
                              eps)
    err = torch.linalg.vector_norm(dx.double() - ref_dx, dim=-1)
    size = torch.maximum(torch.linalg.vector_norm(ref_dx, dim=-1),
                         g.double().abs()).clamp_min(1e-30)
    result = {
        'loss_err': float((loss.double() - ref_loss).abs().max()),
        'lse_err': float((lse.double() - ref_lse).abs().max()),
        'dx_row_err': float((err / size).max()),
        'max_abs_err': float((dx.double() - ref_dx).abs().max()),
        'finite': all(bool(torch.isfinite(t).all()) for t in (loss, lse, dx)),
        'canary': all(bool(torch.isnan(b[n:]).all()) for b in bufs)
        and bool(torch.isnan(dx_buf[n * v:]).all()),
    }
    del x, dx, dx_buf, ref_dx, err
    return result


def ce_ok(result: dict, dtype) -> bool:
    """Every bound of ``ce_check``'s result holds (NaN fails them)."""
    return (result['finite'] and result['canary']
            and result['loss_err'] <= CE_LOSS_TOL
            and result['lse_err'] <= CE_LOSS_TOL
            and result['dx_row_err'] <= CE_ROW_TOL[dtype])


def lse_error(lse: torch.Tensor, ref: torch.Tensor) -> float:
    """max of |lse - ref| / max(1, |ref|); NaN when not finite."""
    ref = ref.float()
    err = (lse.float() - ref).abs() / ref.abs().clamp_min(1.0)
    return float(err.max()) if bool(torch.isfinite(lse).all()) \
        else float('nan')


def qkv_views(b, t, h, d, dtype, gen, device='cuda'):
    """q, k, v as the model hands them over: strided views into one
    [B, T, 3, H, D] projection output, standard normal from ``gen``."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=device,
                      dtype=torch.float32).to(dtype)
    return qkv.unbind(dim=2)


def forward_with_lse(q, k, v, causal: bool):
    """The forward kernel's out and lse, the lse written into a buffer
    filled with NaN first: a row the kernel leaves unwritten stays NaN,
    and ``lse_error`` reports NaN, which fails ``LSE_TOL``."""
    from mlcomp_tpu_torch.ops import flash_attention as fa
    b, t, h, _ = q.shape
    lse = torch.full((b, h, t), float('nan'), device=q.device)
    return fa.flash_attention_forward(q, k, v, causal=causal, with_lse=True,
                                      lse_out=lse)


def backward_check(shape, gen, device='cuda') -> dict:
    """Forward with lse and both backward kernels once at ``shape`` (as
    ``BACKWARD_SHAPES`` lists them) on inputs from ``gen``; returns the
    lse error (``forward_with_lse``: an unwritten row fails it), the row
    errors of dq, dk, dv against
    ``reference_attention_backward`` (fed the kernel forward's out and
    lse), their head and row errors against torch autograd through
    ``reference_attention`` (the row errors for information), their
    largest absolute errors, and whether everything is finite."""
    from mlcomp_tpu_torch.ops import flash_attention as fa
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen, device)
    do = torch.randn((b, t, h, d), generator=gen, device=device,
                     dtype=torch.float32).to(dtype)
    out, lse = forward_with_lse(q, k, v, causal)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    _, ref_lse = fa.reference_attention(q, k, v, causal=causal,
                                        with_lse=True)
    plain = fa.reference_attention_backward(q, k, v, out, lse, do,
                                            causal=causal)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.reference_attention(*leaves, causal=causal).backward(do)
    names = ('dq', 'dk', 'dv')
    # the least row (head) size: a share of the rms row (head) of the
    # gradient itself or of dv, whichever is larger (dq and dk vanish
    # where attention is one-hot, as at T=1; dv = Pᵀ dO does not)
    row_least = {n: BACKWARD_ROW_FLOOR * max(_rms_row(r), _rms_row(plain[2]))
                 for n, r in zip(names, plain)}
    head_least = {n: x * math.sqrt(t) for n, x in row_least.items()}
    return {
        'lse_err': lse_error(lse, ref_lse),
        'row_err': {n: row_relative_error(g, r, row_least[n])
                    for n, g, r in zip(names, grads, plain)},
        'head_err': {n: head_relative_error(g, r, head_least[n])
                     for n, g, r in zip(names, grads, plain)},
        'autograd_head_err': {
            n: head_relative_error(g, x.grad, head_least[n])
            for n, g, x in zip(names, grads, leaves)},
        'autograd_row_err': {
            n: row_relative_error(g, x.grad, row_least[n])
            for n, g, x in zip(names, grads, leaves)},
        'max_abs_err': {n: float((g.float() - r.float()).abs().max())
                        for n, g, r in zip(names, grads, plain)},
        'finite': all(bool(torch.isfinite(g).all()) for g in grads),
    }


def backward_ok(result: dict, dtype) -> bool:
    """Every bound of ``backward_check``'s result holds."""
    return (result['finite'] and result['lse_err'] <= LSE_TOL
            and all(e <= BACKWARD_ROW_TOL[dtype]
                    for e in result['row_err'].values())
            and all(e <= BACKWARD_HEAD_TOL[dtype]
                    for e in result['head_err'].values())
            and all(e <= AUTOGRAD_HEAD_TOL[dtype]
                    for e in result['autograd_head_err'].values()))


def _rms_row(x: torch.Tensor) -> float:
    """Root mean square of the row norms (last dim) of ``x``."""
    rows = torch.linalg.vector_norm(x.float().flatten(0, -2), dim=-1)
    return float(rows.square().mean().sqrt())


def head_relative_error(out: torch.Tensor, ref: torch.Tensor,
                        least: float = 0.0) -> float:
    """max over (b, h) of |out - ref| / max(|ref|, least), the norms over
    the head's whole [T, D] of [B, T, H, D] tensors; NaN when ``out`` is
    not finite."""
    err = torch.linalg.vector_norm((out.float() - ref.float()),
                                   dim=(1, 3))
    size = torch.linalg.vector_norm(ref.float(), dim=(1, 3))
    return float((err / size.clamp_min(max(least, 1e-30))).max())


def row_relative_error(out: torch.Tensor, ref: torch.Tensor,
                       least: float = 0.0) -> float:
    """max over rows (all leading dims) of |out - ref| / max(|ref|,
    least) along the last dim; NaN when ``out`` is not finite, so a bound
    check fails. ``least`` > 0 measures rows smaller than it against it
    (a row whose exact value is 0 holds only rounding noise)."""
    out = out.float().flatten(0, -2)
    ref = ref.float().flatten(0, -2)
    err = torch.linalg.vector_norm(out - ref, dim=-1)
    size = torch.linalg.vector_norm(ref, dim=-1)
    return float((err / size.clamp_min(max(least, 1e-30))).max())


__all__ = ['CE_CANARY', 'CE_LOGIT_SCALE', 'CE_LOSS_TOL', 'CE_ROW_TOL',
           'CE_SHAPES', 'ce_check', 'ce_inputs', 'ce_ok',
           'ATTENTION_ROW_TOL', 'ATTENTION_SHAPES', 'AUTOGRAD_HEAD_TOL',
           'BACKWARD_HEAD_TOL', 'BACKWARD_ROW_FLOOR', 'BACKWARD_ROW_TOL',
           'BACKWARD_SHAPES', 'CANARY_ROWS', 'CIFAR_SITE_ACTS',
           'INT8_EPILOGUE_SHAPES', 'INT8_ROW_TOL', 'INT8_SHAPES',
           'INT8_TRAIN_SHAPES', 'int8_epilogue_check', 'int8_epilogue_ok',
           'INT8_TRAIN_TOL', 'LSE_TOL', 'STACK_ROW_TOL',
           'STACK_SHAPES', 'int8_check', 'int8_inputs', 'int8_ok',
           'int8_train_check', 'int8_train_ok',
           'stack_check', 'stack_inputs', 'stack_ok', 'stack_tol',
           'NORM_COLUMN_FLOOR', 'NORM_SHAPES', 'NORM_STAT_TOL', 'NORM_Y_TOL',
           'backward_check', 'backward_ok', 'cifar_norm_sites',
           'forward_with_lse', 'head_relative_error', 'lse_error',
           'norm_check', 'norm_inputs', 'norm_ok', 'qkv_views',
           'row_relative_error']

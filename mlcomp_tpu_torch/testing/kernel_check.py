"""How the card-side checks hold the kernels against their plain
versions (``chip_smoke.py`` and ``kernel_faults``): the attention
kernels first, then the fused batch-norm+ReLU ("Fused norm"), then the
weight-only int8 matmul and the serving stack ("Int8 serving").

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
#: first (batch 4, T=8192, 16 heads of 64, causal, bf16), then long
#: sequences causal and not, ragged T, every head dim, fp16, f32 (the
#: SIMT path), T=1 and a T just past one K/V tile
ATTENTION_SHAPES = [
    (4, 8192, 16, 64, torch.bfloat16, True),
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
#: 64, causal, bf16), then non-causal, ragged T, every head dim, fp16,
#: f32 (the SIMT path, both head-dim extremes) and T=1
BACKWARD_SHAPES = [
    (1, 8192, 16, 64, torch.bfloat16, True),
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
#: head at batch 4 (M = 4·8192), then ragged shapes: K on the scalar
#: path with a split (5×1000×999), one row and one K tile (1×64×10),
#: M and N tails without a split (200×64×1000), and a split K with an
#: N tail (37×4096×1000)
INT8_SHAPES = [(64, 8192, 8192), (32768, 1024, 4096), (32768, 4096, 1024),
               (32768, 1024, 32768), (5, 1000, 999), (1, 64, 10),
               (200, 64, 1000), (37, 4096, 1000)]
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
#: (M = 5; M = 7 with K = N = 1000, the scalar load path)
STACK_SHAPES = [(8, 64, 8192, torch.int8, True),
                (8, 64, 8192, torch.bfloat16, True),
                (1, 64, 8192, torch.int8, False),
                (3, 64, 1024, torch.bfloat16, False),
                (3, 5, 1024, torch.int8, True),
                (2, 7, 1000, torch.int8, True)]
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


def backward_check(shape, gen, device='cuda') -> dict:
    """Forward with lse and both backward kernels once at ``shape`` (as
    ``BACKWARD_SHAPES`` lists them) on inputs from ``gen``; returns the
    lse error, the row errors of dq, dk, dv against
    ``reference_attention_backward`` (fed the kernel forward's out and
    lse), their head and row errors against torch autograd through
    ``reference_attention`` (the row errors for information), their
    largest absolute errors, and whether everything is finite."""
    from mlcomp_tpu_torch.ops import flash_attention as fa
    b, t, h, d, dtype, causal = shape
    q, k, v = qkv_views(b, t, h, d, dtype, gen, device)
    do = torch.randn((b, t, h, d), generator=gen, device=device,
                     dtype=torch.float32).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                          with_lse=True)
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


__all__ = ['ATTENTION_ROW_TOL', 'ATTENTION_SHAPES', 'AUTOGRAD_HEAD_TOL',
           'BACKWARD_HEAD_TOL', 'BACKWARD_ROW_FLOOR', 'BACKWARD_ROW_TOL',
           'BACKWARD_SHAPES', 'CANARY_ROWS', 'CIFAR_SITE_ACTS',
           'INT8_ROW_TOL', 'INT8_SHAPES', 'LSE_TOL', 'STACK_ROW_TOL',
           'STACK_SHAPES', 'int8_check', 'int8_inputs', 'int8_ok',
           'stack_check', 'stack_inputs', 'stack_ok', 'stack_tol',
           'NORM_COLUMN_FLOOR', 'NORM_SHAPES', 'NORM_STAT_TOL', 'NORM_Y_TOL',
           'backward_check', 'backward_ok', 'cifar_norm_sites',
           'head_relative_error', 'lse_error', 'norm_check', 'norm_inputs',
           'norm_ok', 'qkv_views', 'row_relative_error']

"""How the card-side checks hold the kernels against their plain
versions (``chip_smoke.py`` and ``kernel_faults``): the attention
kernels first, the fused batch-norm+ReLU at the end ("Fused norm").

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
           'BACKWARD_SHAPES', 'CIFAR_SITE_ACTS', 'LSE_TOL',
           'NORM_COLUMN_FLOOR', 'NORM_SHAPES', 'NORM_STAT_TOL', 'NORM_Y_TOL',
           'backward_check', 'backward_ok', 'cifar_norm_sites',
           'head_relative_error', 'lse_error', 'norm_check', 'norm_inputs',
           'norm_ok', 'qkv_views', 'row_relative_error']

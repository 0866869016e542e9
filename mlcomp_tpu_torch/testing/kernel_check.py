"""How the card-side checks hold the attention kernels against their
plain versions (``chip_smoke.py`` and ``kernel_faults``).

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
           'BACKWARD_HEAD_TOL', 'BACKWARD_ROW_FLOOR', 'BACKWARD_ROW_TOL', 'BACKWARD_SHAPES', 'LSE_TOL', 'backward_check',
           'backward_ok', 'head_relative_error', 'lse_error',
           'qkv_views', 'row_relative_error']

"""How the card-side checks hold the attention kernel against its plain
version (``chip_smoke.py`` and ``kernel_faults``).

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


def qkv_views(b, t, h, d, dtype, gen, device='cuda'):
    """q, k, v as the model hands them over: strided views into one
    [B, T, 3, H, D] projection output, standard normal from ``gen``."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=device,
                      dtype=torch.float32).to(dtype)
    return qkv.unbind(dim=2)


def row_relative_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (all leading dims) of |out - ref| / |ref| along the
    last dim; NaN when ``out`` is not finite, so a bound check fails."""
    out = out.float().flatten(0, -2)
    ref = ref.float().flatten(0, -2)
    err = torch.linalg.vector_norm(out - ref, dim=-1)
    size = torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)
    return float((err / size).max())


__all__ = ['ATTENTION_ROW_TOL', 'ATTENTION_SHAPES', 'qkv_views',
           'row_relative_error']

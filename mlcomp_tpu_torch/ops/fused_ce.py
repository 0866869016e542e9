"""Softmax cross-entropy per example, dense half — port of
``mlcomp_tpu/ops/fused_ce.py``.

``softmax_ce_per_example`` with ``impl`` ``auto`` or ``dense`` is the
dense formulation, which is what ``auto`` always is in the JAX package
too. The TPU's blocked CE kernels (``_pallas_ce_fwd`` / ``_pallas_ce_bwd``)
are not ported yet: ``impl='pallas'`` (or ``'cuda'``) raises, naming
ROADMAP B5.
"""

import torch

IMPLS = ('auto', 'dense', 'pallas', 'cuda')


def reference_ce(logits, labels, z_loss: float = 0.0,
                 label_smoothing: float = 0.0):
    """Exact per-example CE in f32 over [N, V] logits and [N] labels.

    ``z_loss`` adds ``z * logsumexp^2``; ``label_smoothing`` gives
    ``lse - (1-eps)*picked - (eps/V)*sum(logits)``."""
    logits = logits.float()
    v = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None].long())[:, 0]
    loss = lse - picked
    if label_smoothing:
        eps = float(label_smoothing)
        loss = (lse - (1.0 - eps) * picked
                - (eps / v) * logits.sum(dim=-1))
    if z_loss:
        loss = loss + float(z_loss) * lse * lse
    return loss


def softmax_ce_per_example(logits, labels, block_n: int = 256,
                           block_v: int = 1024, impl: str = 'auto',
                           interpret: bool = False, z_loss: float = 0.0,
                           label_smoothing: float = 0.0):
    """Per-example softmax CE over [N, V] logits and [N] int labels, f32
    losses. ``impl``: ``auto`` / ``dense`` (the dense formulation);
    ``pallas`` / ``cuda`` (the blocked kernel) are not ported yet.
    ``block_n``, ``block_v`` and ``interpret`` are the kernel's and are
    accepted for the JAX signature's sake.

    Labels outside [0, V) are clamped to the nearest valid index, as in
    the JAX package; there is no ignore-index convention."""
    if impl not in IMPLS:
        raise ValueError(f'unknown impl {impl!r}; '
                         f"use 'auto', 'pallas', or 'dense'")
    if impl in ('pallas', 'cuda'):
        raise NotImplementedError(
            f"softmax_ce_per_example impl={impl!r}: the blocked CE kernels "
            f'are not ported yet (ROADMAP.md, queue B: B5); use '
            f"impl='auto' or 'dense'")
    v = logits.shape[-1]
    labels = labels.long().clamp(0, v - 1)
    return reference_ce(logits, labels, z_loss=z_loss,
                        label_smoothing=label_smoothing)


__all__ = ['softmax_ce_per_example', 'reference_ce']

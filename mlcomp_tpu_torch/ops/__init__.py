"""Custom ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them (counterpart of ``mlcomp_tpu/ops``).

Only the flash-attention forward is ported so far; the other TPU
kernels are listed in ROADMAP.md as still to be ported.
"""

from mlcomp_tpu_torch.ops.flash_attention import (
    flash_attention_forward, fused_attention, reference_attention,
    resolve_impl,
)

__all__ = ['fused_attention', 'flash_attention_forward',
           'reference_attention', 'resolve_impl']

"""Custom ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them (counterpart of ``mlcomp_tpu/ops``).

Ported so far: flash attention, forward (with its row logsumexp) and
backward, the fused batch-norm+ReLU (``fused_norm``), and the dense
half of the cross-entropy (``fused_ce``); the other TPU kernels are
listed in ROADMAP.md as still to be ported.
"""

from mlcomp_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_backward, flash_attention_forward,
    fused_attention, reference_attention, reference_attention_backward,
    resolve_impl,
)
from mlcomp_tpu_torch.ops.fused_norm import (
    fused_norm_act, norm_act_forward, reference_norm_act,
)

__all__ = ['fused_attention', 'flash_attention_forward',
           'flash_attention_backward', 'FlashAttention',
           'reference_attention', 'reference_attention_backward',
           'resolve_impl', 'fused_norm_act', 'norm_act_forward',
           'reference_norm_act']

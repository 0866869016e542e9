"""Custom ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them (counterpart of ``mlcomp_tpu/ops``).

Ported so far: flash attention, forward (with its row logsumexp) and
backward, the fused batch-norm+ReLU (``fused_norm``), the weight-only
int8 matmul of the serving path (``int8_matmul``, with ``Int8Dense``),
the fused multi-layer serving stack (``serving_stack``), and the dense
half of the cross-entropy (``fused_ce``); the cross-entropy's kernels
are listed in ROADMAP.md as still to be ported.
"""

from mlcomp_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_backward, flash_attention_forward,
    fused_attention, reference_attention, reference_attention_backward,
    resolve_impl,
)
from mlcomp_tpu_torch.ops.fused_norm import (
    fused_norm_act, norm_act_forward, reference_norm_act,
)
from mlcomp_tpu_torch.ops.int8_matmul import (
    Int8Dense, int8_matmul, quantize_int8, reference_int8_matmul,
)
from mlcomp_tpu_torch.ops.serving_stack import (
    FEED_EPS, make_chain_runner, quantize_stack, reference_stack,
    serving_stack, stack_feed,
)

__all__ = ['fused_attention', 'flash_attention_forward',
           'flash_attention_backward', 'FlashAttention',
           'reference_attention', 'reference_attention_backward',
           'resolve_impl', 'fused_norm_act', 'norm_act_forward',
           'reference_norm_act', 'int8_matmul', 'quantize_int8',
           'reference_int8_matmul', 'Int8Dense', 'serving_stack',
           'reference_stack', 'quantize_stack', 'stack_feed',
           'make_chain_runner', 'FEED_EPS']

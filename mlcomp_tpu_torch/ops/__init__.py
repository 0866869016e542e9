"""Custom ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them (counterpart of ``mlcomp_tpu/ops``).

Every TPU kernel of the JAX package has its counterpart here: flash
attention, forward (with its row logsumexp) and backward, the fused
batch-norm+ReLU (``fused_norm``), the weight-only int8 matmul of the
serving path (``int8_matmul``, with ``Int8Dense``), the fused
multi-layer serving stack (``serving_stack``) and the blocked softmax
cross-entropy, forward and backward (``fused_ce``). ``int8_matmul`` also
holds the dynamic int8 training product (``int8_train_matmul``, a jnp
custom_vjp in the JAX package, no kernel of its own).
"""

from mlcomp_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_backward, flash_attention_forward,
    fused_attention, reference_attention, reference_attention_backward,
    resolve_impl,
)
from mlcomp_tpu_torch.ops.fused_ce import (
    FusedCE, ce_backward, ce_forward, reference_ce, reference_ce_bwd,
    reference_ce_fwd, softmax_ce_per_example,
)
from mlcomp_tpu_torch.ops.fused_norm import (
    fused_norm_act, norm_act_forward, reference_norm_act,
)
from mlcomp_tpu_torch.ops.int8_matmul import (
    Int8Dense, Int8TrainMatmul, int8_matmul, int8_train_matmul,
    quantize_int8, reference_int8_matmul, reference_int8_train_matmul,
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
           'make_chain_runner', 'FEED_EPS', 'softmax_ce_per_example',
           'reference_ce', 'reference_ce_fwd', 'reference_ce_bwd',
           'ce_forward', 'ce_backward', 'FusedCE', 'int8_train_matmul',
           'Int8TrainMatmul', 'reference_int8_train_matmul']

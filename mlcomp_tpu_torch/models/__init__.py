"""Model zoo of the port (counterpart of ``mlcomp_tpu/models``).

Only ``transformer_lm`` is ported so far; ``create_model`` of any other
name raises with the list of ported names.
"""

from mlcomp_tpu_torch.models.base import (
    create_model, model_names, param_count, register_model,
)
from mlcomp_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM,
)

__all__ = ['create_model', 'model_names', 'param_count', 'register_model',
           'TransformerConfig', 'TransformerLM']

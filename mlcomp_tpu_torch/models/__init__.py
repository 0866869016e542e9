"""Model zoo of the port (counterpart of ``mlcomp_tpu/models``).

Ported so far: ``transformer_lm`` (dense or MoE), ``vit``, ``mlp`` and
the ResNets (``resnet18`` … ``resnet152``, with ``norm`` ``batch``/
``fused``/``none``); ``create_model`` of any other name raises with the
list of ported names.
"""

from mlcomp_tpu_torch.models.base import (
    create_model, model_names, param_count, register_model,
)
from mlcomp_tpu_torch.models.mlp import MLP
from mlcomp_tpu_torch.models.resnet import ResNet
from mlcomp_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM,
)
from mlcomp_tpu_torch.models.vit import ViT

__all__ = ['create_model', 'model_names', 'param_count', 'register_model',
           'TransformerConfig', 'TransformerLM', 'ViT', 'MLP', 'ResNet']

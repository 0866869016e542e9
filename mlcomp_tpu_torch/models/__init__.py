"""Model zoo of the port (counterpart of ``mlcomp_tpu/models``).

Every name of the JAX registry but ``pipelined_lm`` (pipeline
parallelism, ROADMAP.md A4): ``transformer_lm`` (dense or MoE), ``vit``,
``mlp``, the ResNets (``resnet18`` … ``resnet152``, with ``norm``
``batch``/``fused``/``none``), the 13 encoder families as classifiers
(``vgg13`` … ``inceptionresnetv2``, ``models/encoders.py``), the
segmentation decoders ``fpn``/``linknet``/``pspnet``/``deeplabv3`` bare
and as ``{decoder}_{encoder}``, ``unet_{encoder}``
(``models/segmentation.py``) and the standalone ``unet``
(``models/unet.py``); ``create_model`` of another name raises with the
list of ported names.
"""

from mlcomp_tpu_torch.models.base import (
    create_model, model_names, param_count, register_model,
)
from mlcomp_tpu_torch.models.mlp import MLP
from mlcomp_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from mlcomp_tpu_torch.models.segmentation import (
    DeepLabV3, FPN, LinkNet, PSPNet, ResNetEncoder, UNetDecoder,
)
from mlcomp_tpu_torch.models.encoders import (
    DenseNetEncoder, EfficientNetEncoder, EncoderClassifier, VGGEncoder,
    make_family_encoder,
)
from mlcomp_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM,
)
from mlcomp_tpu_torch.models.unet import UNet
from mlcomp_tpu_torch.models.vit import ViT

__all__ = ['create_model', 'model_names', 'param_count', 'register_model',
           'MLP', 'ResNet', 'BasicBlock', 'Bottleneck',
           'TransformerConfig', 'TransformerLM', 'UNet', 'ViT',
           'ResNetEncoder', 'FPN', 'LinkNet', 'PSPNet', 'DeepLabV3',
           'UNetDecoder', 'VGGEncoder', 'DenseNetEncoder',
           'EfficientNetEncoder', 'EncoderClassifier', 'make_family_encoder']

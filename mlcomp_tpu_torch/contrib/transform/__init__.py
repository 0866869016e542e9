from mlcomp_tpu_torch.contrib.transform.numpy_aug import (
    Compose, Cutout, HorizontalFlip, PadCrop, Transform, Transpose,
    VerticalFlip, augment_batch, parse_transforms,
)
from mlcomp_tpu_torch.contrib.transform.rle import mask2rle, rle2mask
from mlcomp_tpu_torch.contrib.transform.tta import (
    TtaHFlip, TtaTransform, TtaTranspose, TtaVFlip, parse_tta,
    tta_predict,
)

__all__ = [
    'Transform', 'Compose', 'HorizontalFlip', 'VerticalFlip', 'Transpose',
    'PadCrop', 'Cutout', 'augment_batch', 'parse_transforms',
    'mask2rle', 'rle2mask',
    'TtaTransform', 'TtaHFlip', 'TtaVFlip', 'TtaTranspose', 'parse_tta',
    'tta_predict',
]

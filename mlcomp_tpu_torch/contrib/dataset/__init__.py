from mlcomp_tpu_torch.contrib.dataset.classify import (
    ImageDataset, NpzDataset, apply_fold_filter, balance_max_count,
    read_folds,
)
from mlcomp_tpu_torch.contrib.dataset.segment import ImageWithMaskDataset

__all__ = ['ImageDataset', 'NpzDataset', 'ImageWithMaskDataset',
           'apply_fold_filter', 'balance_max_count', 'read_folds']

from mlcomp_tpu_torch.contrib.dataset.classify import (
    ImageDataset, NpzDataset, read_folds,
)

__all__ = ['ImageDataset', 'NpzDataset', 'read_folds']

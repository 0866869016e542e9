"""Segmentation dataset — port of
``mlcomp_tpu/contrib/dataset/segment.py``.

Image + mask pairs with the fold filtering of ``ImageDataset``. A mask
loads from ``mask_folder`` (the image's stem, ``.npy`` then ``.png``,
read gray), else from the RLE string in the fold csv's ``rle_key``
column (``contrib/transform/rle.py``), else is all zeros.
"""

import os
from typing import Optional

import numpy as np

from mlcomp_tpu_torch.contrib.dataset.classify import (
    _read_image, apply_fold_filter,
)
from mlcomp_tpu_torch.contrib.transform.rle import rle2mask


class ImageWithMaskDataset:
    def __init__(self, *, img_folder: str, mask_folder: str = None,
                 fold_csv: str = None, fold_number: int = None,
                 is_test: bool = False, rle_key: str = 'rle',
                 num_classes: int = 2, transforms=None,
                 max_count: Optional[int] = None):
        if fold_csv:
            rows = apply_fold_filter(None, fold_csv, fold_number, is_test)
        else:
            rows = [{'image': f} for f in sorted(os.listdir(img_folder))]
        if max_count is not None:
            rows = rows[:int(max_count)]
        self.rows = rows
        self.img_folder = img_folder
        self.mask_folder = mask_folder
        self.rle_key = rle_key
        self.num_classes = num_classes
        self.transforms = transforms
        self._cache = None

    def __len__(self):
        return len(self.rows)

    def _mask_for(self, row, shape) -> np.ndarray:
        if self.mask_folder:
            stem = os.path.splitext(row['image'])[0]
            for ext in ('.npy', '.png'):
                path = os.path.join(self.mask_folder, stem + ext)
                if os.path.exists(path):
                    m = _read_image(path, gray_scale=True) \
                        if ext == '.png' else np.load(path)
                    return m.astype(np.int32)
        if self.rle_key in row and isinstance(row[self.rle_key], str):
            return rle2mask(row[self.rle_key],
                            (shape[1], shape[0])).astype(np.int32)
        return np.zeros(shape[:2], np.int32)

    def __getitem__(self, i: int) -> dict:
        row = self.rows[i]
        img = _read_image(os.path.join(self.img_folder, row['image']))
        mask = self._mask_for(row, img.shape)
        img = img.astype(np.float32)
        if self.transforms is not None:
            img, mask = self.transforms(img, mask)
        return {'features': img, 'targets': mask,
                'image_name': row['image']}

    def arrays(self):
        if self._cache is None:
            items = [self[i] for i in range(len(self))]
            x = np.stack([it['features'] for it in items])
            y = np.stack([it['targets'] for it in items])
            self._cache = (x.astype(np.float32), y.astype(np.int32))
        return self._cache


__all__ = ['ImageWithMaskDataset']

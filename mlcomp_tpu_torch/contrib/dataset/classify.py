"""Classification datasets — port of
``mlcomp_tpu/contrib/dataset/classify.py``.

A dataset materialises dense numpy arrays that the batch pipeline (or
an ``Infer``/``Valid`` executor) takes whole. Fold files are read with
``utils/csv_io`` (the card's machine has no pandas), typed as pandas
types them, and filtered as the JAX package filters them: ``fold == n``
is the evaluation split, the rest is train. Images are read without
OpenCV: ``.npy`` with numpy, ``.png`` with ``utils/png.py``, which gives
what ``cv2.imread`` gives (RGB order); any other format raises.
"""

import os
from numbers import Number
from typing import Callable, Optional

import numpy as np

from mlcomp_tpu_torch.utils.csv_io import n_rows, read_csv
from mlcomp_tpu_torch.utils.png import read_png


def _read_image(path: str, gray_scale: bool = False) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == '.npy':
        return np.load(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f'could not read image {path!r}')
    return read_png(path, gray_scale)


def read_folds(fold_csv: str) -> np.ndarray:
    """The ``fold`` column of a fold file."""
    columns = read_csv(fold_csv)
    if 'fold' not in columns:
        raise KeyError(f'{fold_csv} has no fold column')
    return columns['fold']


def _records(columns: dict) -> list:
    """The rows of a table as dicts of Python scalars (pandas'
    ``to_dict(orient='records')``)."""
    names = list(columns)
    return [{k: columns[k][i].item() if isinstance(
                columns[k][i], np.generic) else columns[k][i]
             for k in names} for i in range(n_rows(columns))]


def apply_fold_filter(rows, fold_csv: Optional[str],
                      fold_number: Optional[int], is_test: bool):
    """``fold == k`` is validation, the rest is train."""
    if not fold_csv:
        return rows
    columns = read_csv(fold_csv)
    if rows is None:
        rows = _records(columns)
        if fold_number is None:
            return rows
    folds = np.asarray(columns['fold'])
    keep = (folds == fold_number) if is_test else (folds != fold_number)
    return [r for r, k in zip(rows, keep) if k]


def balance_max_count(rows: list, max_count, label_key: str = 'label'):
    """Class-balanced truncation: a list ``max_count`` keeps classes in
    the given ratio, anchored at the class that most constrains it."""
    if max_count is None:
        return rows
    if isinstance(max_count, Number):
        return rows[:int(max_count)]
    by_label = {}
    for row in rows:
        by_label.setdefault(int(row[label_key]), []).append(row)
    ratios = list(max_count)
    # classes absent from the rows do not constrain the ratio
    scale = min(
        (len(by_label[cls]) / ratios[cls]
         for cls in by_label if cls < len(ratios) and ratios[cls] > 0),
        default=0)
    out = []
    for cls in sorted(by_label):
        want = int(scale * ratios[cls]) if cls < len(ratios) \
            else len(by_label[cls])
        out.extend(by_label[cls][:want])
    return out


class ImageDataset:
    """Folder-of-images + fold-csv classification dataset.

    ``arrays()`` returns (x: float32 NHWC, y: int32 N, None without a
    ``label`` column); images load on first access and are kept.
    """

    def __init__(self, *, img_folder: str, fold_csv: str = None,
                 fold_number: int = None, is_test: bool = False,
                 gray_scale: bool = False, max_count=None,
                 transforms=None,
                 postprocess_func: Callable[[dict], dict] = None):
        self.img_folder = img_folder
        if fold_csv:
            rows = apply_fold_filter(None, fold_csv, fold_number, is_test)
        else:
            rows = [{'image': f} for f in sorted(os.listdir(img_folder))]
        rows = balance_max_count(rows, max_count)
        self.rows = rows
        self.gray_scale = gray_scale
        self.transforms = transforms
        self.postprocess_func = postprocess_func
        self._cache = None

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        row = self.rows[i]
        img = _read_image(os.path.join(self.img_folder, row['image']),
                          self.gray_scale)
        item = {'features': img.astype(np.float32),
                'image_name': row['image']}
        if 'label' in row:
            item['targets'] = int(row['label'])
        if self.transforms is not None:
            item['features'], _ = self.transforms(item['features'])
        if self.postprocess_func is not None:
            item = self.postprocess_func(item)
        return item

    def arrays(self):
        if self._cache is None:
            xs = [self[i]['features'] for i in range(len(self))]
            x = np.stack(xs).astype(np.float32)
            y = None
            if self.rows and 'label' in self.rows[0]:
                y = np.array([int(r['label']) for r in self.rows],
                             np.int32)
            self._cache = (x, y)
        return self._cache


class NpzDataset:
    """Array-file dataset with the fold semantics of the JAX package
    (x: NHWC, y: N; a fold file filters rows when ``fold_number`` is
    given)."""

    def __init__(self, *, path: str, fold_csv: str = None,
                 fold_number: int = None, is_test: bool = False,
                 x_key: str = 'x', y_key: str = 'y', max_count=None):
        data = np.load(path)
        x = data[x_key]
        y = data[y_key] if y_key in data else None
        keep = np.ones(len(x), bool)
        if fold_csv and fold_number is not None:
            folds = read_folds(fold_csv)
            keep = (folds == fold_number) if is_test \
                else (folds != fold_number)
        self.x = x[keep].astype(np.float32)
        self.y = None if y is None else np.asarray(y)[keep].astype(np.int32)
        if isinstance(max_count, Number):
            self.x = self.x[:int(max_count)]
            if self.y is not None:
                self.y = self.y[:int(max_count)]

    def __len__(self):
        return len(self.x)

    def arrays(self):
        return self.x, self.y


__all__ = ['ImageDataset', 'NpzDataset', 'apply_fold_filter',
           'balance_max_count', 'read_folds']

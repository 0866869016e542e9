"""Classification datasets — port of ``NpzDataset`` from
``mlcomp_tpu/contrib/dataset/classify.py``.

A dataset materialises dense numpy arrays that the batch pipeline (or
an ``Infer``/``Valid`` executor) takes whole. The fold file is read with
the standard ``csv`` module (the card's machine has no pandas) and
filtered as the JAX package filters it: ``fold == n`` is the evaluation
split, the rest is train. ``ImageDataset`` (image folders, which the JAX
package reads with OpenCV) is not ported yet.
"""

import csv
from numbers import Number

import numpy as np


def _number(text: str):
    """A csv cell as pandas would type a numeric column: int, else
    float."""
    try:
        return int(text)
    except ValueError:
        return float(text)


def read_folds(fold_csv: str) -> np.ndarray:
    """The ``fold`` column of a fold file."""
    with open(fold_csv, newline='') as fh:
        reader = csv.DictReader(fh)
        if 'fold' not in (reader.fieldnames or ()):
            raise KeyError(f'{fold_csv} has no fold column')
        return np.asarray([_number(row['fold']) for row in reader])


class ImageDataset:
    """Folder-of-images + fold-csv dataset: not ported yet."""

    def __init__(self, **_):
        raise NotImplementedError(
            'ImageDataset (img_folder: datasets, read with OpenCV) is not '
            'ported yet (ROADMAP.md, queue A: A5, image folders); use a '
            'registered dataset (name:) or an array file (path:)')


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


__all__ = ['ImageDataset', 'NpzDataset', 'read_folds']

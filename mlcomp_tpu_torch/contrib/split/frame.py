"""Fold splitters — port of ``mlcomp_tpu/contrib/split/frame.py``.

Numpy implementations: given a label column (and optionally a group
column), an int fold id per row, balanced per class, deterministic under
``seed``. A column given by name is read from ``df`` (a mapping of
column name to values, as ``utils/csv_io.read_csv`` returns) or from the
csv ``file``, typed as pandas types it.
"""

from collections import defaultdict
from typing import Optional, Sequence, Union

import numpy as np

from mlcomp_tpu_torch.utils.csv_io import read_csv


def _as_labels(label: Union[str, Sequence], df=None, file: str = None):
    """Accept a raw label array, or a column name + columns/csv."""
    if isinstance(label, str):
        if df is None:
            if file is None:
                raise ValueError('label given by name needs df= or file=')
            df = read_csv(file)
        return np.asarray(df[label]), df
    return np.asarray(label), df


def stratified_k_fold(label, df=None, file: str = None, n_splits: int = 5,
                      seed: int = 0) -> np.ndarray:
    """Per-row fold ids with each class spread evenly across folds.

    Shuffles within each class, then deals class members round-robin into
    folds — every fold gets ``count/n_splits`` (±1) samples of each class.
    """
    y, _ = _as_labels(label, df, file)
    rng = np.random.RandomState(seed)
    folds = np.zeros(len(y), np.int64)
    for cls in np.unique(y):
        members = np.flatnonzero(y == cls)
        rng.shuffle(members)
        folds[members] = np.arange(len(members)) % n_splits
    return folds


def group_k_fold(groups, df=None, file: str = None, n_splits: int = 5,
                 seed: int = 0) -> np.ndarray:
    """Fold ids such that no group straddles folds; groups are assigned
    greedily (largest first) to the currently smallest fold."""
    g, _ = _as_labels(groups, df, file)
    uniq, counts = np.unique(g, return_counts=True)
    order = np.argsort(-counts, kind='stable')
    rng = np.random.RandomState(seed)
    # shuffle ties so equal-size groups don't always land identically
    order = order[rng.permutation(len(order))] if seed is not None else order
    order = order[np.argsort(-counts[order], kind='stable')]
    sizes = np.zeros(n_splits, np.int64)
    assign = {}
    for i in order:
        f = int(np.argmin(sizes))
        assign[uniq[i]] = f
        sizes[f] += counts[i]
    return np.array([assign[v] for v in g], np.int64)


def stratified_group_k_fold(label, group_column=None, df=None,
                            file: str = None, n_splits: int = 5,
                            seed: int = 0,
                            groups: Optional[Sequence] = None) -> np.ndarray:
    """Group-exclusive folds that also balance the label distribution.

    Greedy: groups are placed largest-first into the fold where
    they least worsen the per-class imbalance.
    """
    y, df = _as_labels(label, df, file)
    if groups is None:
        if group_column is None:
            raise ValueError('need group_column= or groups=')
        g = np.asarray(df[group_column])
    else:
        g = np.asarray(groups)
    classes = {c: i for i, c in enumerate(np.unique(y))}
    n_cls = len(classes)

    per_group = defaultdict(lambda: np.zeros(n_cls, np.int64))
    for gi, yi in zip(g, y):
        per_group[gi][classes[yi]] += 1
    rng = np.random.RandomState(seed)
    names = list(per_group)
    rng.shuffle(names)
    names.sort(key=lambda k: -per_group[k].sum())

    fold_counts = np.zeros((n_splits, n_cls), np.int64)
    assign = {}
    for name in names:
        vec = per_group[name]
        # imbalance = max-min spread per class after hypothetical add
        best_f, best_cost = 0, None
        for f in range(n_splits):
            fold_counts[f] += vec
            cost = (fold_counts.max(0) - fold_counts.min(0)).sum()
            fold_counts[f] -= vec
            if best_cost is None or cost < best_cost:
                best_f, best_cost = f, cost
        assign[name] = best_f
        fold_counts[best_f] += vec
    return np.array([assign[v] for v in g], np.int64)


__all__ = ['stratified_k_fold', 'stratified_group_k_fold', 'group_k_fold']

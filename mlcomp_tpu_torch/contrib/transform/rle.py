"""Run-length mask codec — port of ``mlcomp_tpu/contrib/transform/rle.py``:
column-major, 1-indexed start/length pairs (the Kaggle segmentation
convention)."""

import numpy as np


def mask2rle(mask: np.ndarray) -> str:
    """Binary HxW mask -> 'start length start length ...' (1-indexed,
    column-major scan order)."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    edges = np.diff(np.concatenate([[0], flat, [0]]))
    starts = np.flatnonzero(edges == 1) + 1
    ends = np.flatnonzero(edges == -1) + 1
    return ' '.join(
        f'{s} {e - s}' for s, e in zip(starts, ends))


def rle2mask(rle: str, shape) -> np.ndarray:
    """Inverse of mask2rle; ``shape`` is (width, height) per the
    reference's convention."""
    flat = np.zeros(shape[0] * shape[1], np.uint8)
    tokens = [int(t) for t in rle.split()]
    for start, length in zip(tokens[::2], tokens[1::2]):
        flat[start - 1:start - 1 + length] = 1
    return flat.reshape(shape).T


__all__ = ['mask2rle', 'rle2mask']

"""Host-side numpy augmentations — port of
``mlcomp_tpu/contrib/transform/numpy_aug.py`` (numpy only, so the same
code: the same ``RandomState`` draws in the same order give the same
arrays as the JAX package).

Augmentation runs on the host over HWC arrays, overlapped with the
card's step by the trainer's prefetcher (``train/data.py``); casts run
on the device. Each transform is a callable ``(image, mask=None, rng)
-> (image, mask)``; ``p`` gates random application. ``augment_batch``
runs a whole NHWC batch through the vectorised ``apply_batch`` of every
transform when each has one, else sample by sample.
"""

from typing import Optional, Sequence

import numpy as np


class Transform:
    p = 1.0

    def apply(self, img, rng):
        return img

    def apply_mask(self, mask, rng):
        return mask

    def __call__(self, img, mask=None, rng: Optional[np.random.RandomState]
                 = None):
        rng = rng or np.random
        if self.p >= 1.0 or rng.rand() < self.p:
            # one draw consumed per transform so img/mask stay aligned
            state = rng.randint(0, 2 ** 31)
            img = self.apply(img, np.random.RandomState(state))
            if mask is not None:
                mask = self.apply_mask(mask, np.random.RandomState(state))
        return img, mask

    def apply_batch(self, x, masks, rng):
        """Vectorized whole-batch variant; None = not supported (the
        caller falls back to the per-sample path). Subclasses override
        it: a per-sample Python loop over a batch is slow on the host."""
        return None


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, img, mask=None, rng=None):
        for t in self.transforms:
            img, mask = t(img, mask, rng)
        return img, mask


class HorizontalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, img, rng):
        return img[..., ::-1, :] if img.ndim == 3 else img[..., ::-1]

    apply_mask = apply

    def apply_batch(self, x, masks, rng):
        # W is axis 2 for every batched rank (NHWC, NHW, NHWk) — matches
        # the per-sample apply's "second spatial axis" flip
        pick = rng.rand(len(x)) < self.p
        x = np.array(x)
        x[pick] = np.flip(x[pick], axis=2)
        if masks is not None:
            masks = np.array(masks)
            masks[pick] = np.flip(masks[pick], axis=2)
        return x, masks


class VerticalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, img, rng):
        return img[::-1] if img.ndim <= 3 else img[:, ::-1]

    apply_mask = apply

    def apply_batch(self, x, masks, rng):
        pick = rng.rand(len(x)) < self.p
        x = np.array(x)
        x[pick] = x[pick][:, ::-1]
        if masks is not None:
            masks = np.array(masks)
            masks[pick] = masks[pick][:, ::-1]
        return x, masks


class Transpose(Transform):
    """Swap H and W."""
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, img, rng):
        axes = (1, 0, 2) if img.ndim == 3 else (1, 0)
        return np.transpose(img, axes)

    apply_mask = apply


class PadCrop(Transform):
    """Reflect-pad by ``pad`` then take a random crop back to the original
    size — the standard CIFAR augmentation (pad 4, crop 32)."""
    def __init__(self, pad: int = 4, p: float = 1.0):
        self.pad = pad
        self.p = p
        self._offset = None

    def apply(self, img, rng):
        pad = self.pad
        width = ((pad, pad), (pad, pad), (0, 0))[:img.ndim]
        padded = np.pad(img, width, mode='reflect')
        dy, dx = rng.randint(0, 2 * pad + 1, 2)
        h, w = img.shape[:2]
        return padded[dy:dy + h, dx:dx + w]

    apply_mask = apply

    def _batch_crop(self, arr, dy, dx):
        pad = self.pad
        n = len(arr)
        h, w = arr.shape[1:3]
        width = ((0, 0), (pad, pad), (pad, pad), (0, 0))[:arr.ndim]
        padded = np.pad(arr, width, mode='reflect')
        rows = dy[:, None] + np.arange(h)[None, :]
        cols = dx[:, None] + np.arange(w)[None, :]
        idx_n = np.arange(n)[:, None, None]
        return padded[idx_n, rows[:, :, None], cols[:, None, :]]

    def apply_batch(self, x, masks, rng):
        n = len(x)
        # per-sample p gate, same distribution as the fallback path;
        # unpicked samples crop at offset `pad` = identity under
        # reflect padding
        pick = rng.rand(n) < self.p
        dy = np.where(pick, rng.randint(0, 2 * self.pad + 1, n),
                      self.pad)
        dx = np.where(pick, rng.randint(0, 2 * self.pad + 1, n),
                      self.pad)
        x = self._batch_crop(x, dy, dx)
        if masks is not None:
            masks = self._batch_crop(masks, dy, dx)
        return x, masks


class Cutout(Transform):
    """Zero a random square — regularizer from the CIFAR SOTA recipes."""
    def __init__(self, size: int = 8, p: float = 0.5):
        self.size = size
        self.p = p

    def apply(self, img, rng):
        h, w = img.shape[:2]
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        s = self.size // 2
        out = img.copy()
        out[max(0, cy - s):cy + s, max(0, cx - s):cx + s] = 0
        return out

    def apply_batch(self, x, masks, rng):
        n = len(x)
        h, w = x.shape[1:3]
        pick = rng.rand(n) < self.p
        cy = rng.randint(0, h, n)
        cx = rng.randint(0, w, n)
        s = self.size // 2
        x = np.array(x)
        for i in np.flatnonzero(pick):   # cheap: zeroing small windows
            x[i, max(0, cy[i] - s):cy[i] + s,
              max(0, cx[i] - s):cx[i] + s] = 0
        return x, masks


def augment_batch(x: np.ndarray, transform: Transform,
                  rng: np.random.RandomState,
                  masks: Optional[np.ndarray] = None):
    """Apply a transform pipeline over an NHWC batch.

    Fast path: when every transform implements ``apply_batch`` the whole
    batch goes through vectorized numpy.
    Otherwise falls back to the per-sample path. Shape-changing
    transforms (Transpose on rectangular images) must be deterministic
    (p=1) so every sample keeps a common shape."""
    chain = transform.transforms if isinstance(transform, Compose) \
        else [transform]
    # decide the path BEFORE mutating anything: a mid-chain fallback
    # would double-apply the transforms already run
    if all(type(t).apply_batch is not Transform.apply_batch
           for t in chain):
        for t in chain:
            x, masks = t.apply_batch(x, masks, rng)
        return (x, masks) if masks is not None else x

    imgs, out_masks = [], []
    for i in range(len(x)):
        img, m = transform(x[i], masks[i] if masks is not None else None,
                           rng)
        imgs.append(img)
        if masks is not None:
            out_masks.append(m)
    shapes = {im.shape for im in imgs}
    if len(shapes) > 1:
        raise ValueError(
            f'transforms produced mixed sample shapes {sorted(shapes)} — '
            f'use p=1.0 for shape-changing transforms on rectangular '
            f'images')
    out = np.stack(imgs)
    if masks is not None:
        return out, np.stack(out_masks)
    return out


_AUG = {
    'hflip': HorizontalFlip, 'vflip': VerticalFlip,
    'transpose': Transpose, 'pad_crop': PadCrop, 'cutout': Cutout,
}


def parse_transforms(specs) -> Compose:
    """Build a Compose from config specs: strings ('hflip') or dicts
    ({name: pad_crop, pad: 4})."""
    out = []
    for spec in specs or ():
        if isinstance(spec, str):
            out.append(_AUG[spec]())
        else:
            spec = dict(spec)
            name = spec.pop('name')
            out.append(_AUG[name](**spec))
    return Compose(out)


__all__ = ['Transform', 'Compose', 'HorizontalFlip', 'VerticalFlip',
           'Transpose', 'PadCrop', 'Cutout', 'augment_batch',
           'parse_transforms']

"""The device-resident dataset path — port of
``mlcomp_tpu/train/device_data.py``.

For a dataset that fits in the card's memory, the whole of it goes to
the device once (images in [0, 1] packed as uint8, 4x fewer bytes), and
each step gathers its batch there by an index vector: the per-epoch
index permutation is the only host→device copy of the training loop.
The augmentations run on the device on the stored pixels (before
dequantization), with the semantics of the JAX package's: ``pad_crop``
(reflect padding, a random window per image), ``hflip``/``vflip``
(each image with probability p) and ``cutout`` (a ``size``-square hole
at a random centre, with probability p). Their random draws come from
an explicit ``torch.Generator`` on the batch's device; they are not
JAX's numbers.
"""

from typing import Optional, Sequence

import numpy as np
import torch


def quantize_dataset(x: np.ndarray):
    """(array, dequant): float images in [0, 1] packed as uint8 (rounded
    x·255), ``dequant`` True; uint8 as it is (True); anything else as it
    is (False)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x, True
    if np.issubdtype(x.dtype, np.floating) and x.size \
            and 0.0 <= float(x.min()) and float(x.max()) <= 1.0:
        return np.round(x * 255.0).astype(np.uint8), True
    return x, False


#: augmentation names the device path understands
DEVICE_AUGMENTS = ('pad_crop', 'hflip', 'vflip', 'cutout')


def normalize_augment_spec(specs) -> Optional[list]:
    """A config augment list as [(name, params)] if every entry is one
    the device path runs, else None (the host pipeline's)."""
    out = []
    for spec in specs or ():
        if isinstance(spec, str):
            name, params = spec, {}
        else:
            params = dict(spec)
            name = params.pop('name')
        if name not in DEVICE_AUGMENTS:
            return None
        out.append((name, params))
    return out


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """Source index of padded position ``i`` (relative to the image's
    first pixel) under numpy's 'reflect' padding (edge not repeated)."""
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _bernoulli(n: int, p: float, generator, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) < p


def make_device_augment(augments: Sequence, image_shape):
    """``augment(x, generator) -> x`` for [B, H, W, C] batches on the
    device; ``generator`` lives on x's device. Every transform is an
    exact copy or zeroing of pixels, so it runs on the stored dtype."""
    h, w = int(image_shape[0]), int(image_shape[1])

    def augment(x, generator):
        n, dev = x.shape[0], x.device
        for name, params in augments:
            if name == 'pad_crop':
                pad = int(params.get('pad', 4))
                if not 0 <= pad < min(h, w):
                    raise ValueError(f'pad_crop pad {pad} must be below the '
                                     f'image size {h}x{w} (reflect padding)')
                dy = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                                   device=dev)
                dx = torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                                   device=dev)
                rows = _reflect(dy[:, None] - pad
                                + torch.arange(h, device=dev), h)
                cols = _reflect(dx[:, None] - pad
                                + torch.arange(w, device=dev), w)
                b = torch.arange(n, device=dev)[:, None, None]
                x = x[b, rows[:, :, None], cols[:, None, :]]
            elif name in ('hflip', 'vflip'):
                flip = _bernoulli(n, float(params.get('p', 0.5)), generator,
                                  dev)[:, None, None, None]
                x = torch.where(flip, x.flip(2 if name == 'hflip' else 1), x)
            elif name == 'cutout':
                size = int(params.get('size', 8))
                p = float(params.get('p', 0.5))
                cy = torch.randint(0, h, (n,), generator=generator,
                                   device=dev)
                cx = torch.randint(0, w, (n,), generator=generator,
                                   device=dev)
                pick = _bernoulli(n, p, generator, dev)
                s = size // 2
                yy = torch.arange(h, device=dev)[None, :, None] \
                    - cy[:, None, None]
                xx = torch.arange(w, device=dev)[None, None, :] \
                    - cx[:, None, None]
                # the [c - s, c + s) window of the host Cutout
                hole = ((yy >= -s) & (yy < s) & (xx >= -s) & (xx < s)
                        & pick[:, None, None])
                x = x.masked_fill(hole[..., None], 0)
            else:
                raise ValueError(f'unknown device augment {name!r}')
        return x

    return augment


def place_dataset(x: np.ndarray, y: Optional[np.ndarray], device):
    """The whole dataset as tensors on ``device`` (one copy each)."""
    device = torch.device(device)
    x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    y_dev = None if y is None else \
        torch.from_numpy(np.ascontiguousarray(y)).to(device)
    return x_dev, y_dev


def dataset_fits_hbm(x: np.ndarray, budget_bytes: int = 2 << 30,
                     extra_bytes: int = 0) -> bool:
    """Does the dataset (plus ``extra_bytes``) fit the device budget?"""
    return x.nbytes + extra_bytes <= budget_bytes


__all__ = ['quantize_dataset', 'normalize_augment_spec',
           'make_device_augment', 'place_dataset', 'dataset_fits_hbm',
           'DEVICE_AUGMENTS']

"""Datasets and the host→device batch pipeline — port of
``mlcomp_tpu/train/data.py``.

The registry and the loaders ported so far: ``npz`` (local files with the
fold split), ``synthetic_lm`` (Markov-chain token streams),
``synthetic_images`` (class prototypes plus noise, CIFAR-shaped),
``cifar10`` (a local npz, else the synthetic stand-in) and ``digits``
(scikit-learn's scans; scikit-learn is imported inside the loader and
its absence raises there). Each makes the same ``np.random.RandomState``
draws as the JAX package, so the same seed gives the same arrays. The
other names of the JAX registry are registered here too and raise,
pointing at ROADMAP.md. Batches go to the card as pinned host tensors
copied with ``non_blocking``, ``depth`` batches ahead of the step that
uses them.
"""

import os
from collections import deque
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_DATASETS = {}


def register_dataset(name: str):
    def deco(fn):
        _DATASETS[name.lower()] = fn
        return fn
    return deco


#: spec keys that name files/folders and get the data/ fallback below
_PATH_KEYS = ('path', 'fold_path', 'fold_csv', 'img_folder',
              'mask_folder')


def resolve_data_paths(spec: Dict) -> Dict:
    """Resolve bare relative filenames in a dataset spec against the
    ``data/`` folder executors get in their task folder."""
    out = dict(spec)
    for key in _PATH_KEYS:
        v = out.get(key)
        if v and isinstance(v, str) and not os.path.isabs(v) \
                and not os.path.exists(v):
            candidate = os.path.join('data', v)
            if os.path.exists(candidate):
                out[key] = candidate
    return out


def create_dataset(name: str, **kwargs) -> Dict[str, np.ndarray]:
    key = name.lower()
    if key not in _DATASETS:
        raise KeyError(
            f'unknown dataset {name!r}; registered: {sorted(_DATASETS)}')
    return _DATASETS[key](**resolve_data_paths(kwargs))


# --------------------------------------------------------------- builtins
@register_dataset('npz')
def _npz(path: str, fold_path: Optional[str] = None, fold: int = 0,
         x_key: str = 'x', y_key: str = 'y', **_):
    """Local-file dataset with a fold-based train/valid split: fold==k is
    validation, the rest is train; without a fold file the last 20%
    validate."""
    data = np.load(path)
    x, y = data[x_key], data[y_key]
    if fold_path:
        if not os.path.exists(fold_path):
            raise FileNotFoundError(
                f'fold_path {fold_path!r} does not exist')
        mask = np.load(fold_path) == fold
    else:
        n = len(y)
        mask = np.zeros(n, bool)
        mask[int(n * 0.8):] = True
    return {'x_train': x[~mask], 'y_train': y[~mask],
            'x_valid': x[mask], 'y_valid': y[mask]}


@register_dataset('synthetic_lm')
def _synth_lm(n_train: int = 2048, n_valid: int = 256,
              seq_len: int = 256, vocab_size: int = 1024,
              seed: int = 0, **_):
    """Markov-chain token streams — gives a real (learnable) LM loss. The
    transition matrix is [vocab, vocab] f64: at vocab 32768 that is
    8.6 GB, so large vocabularies come from an npz instead."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab_size) * 0.05, size=vocab_size)
    cum = np.cumsum(trans, axis=1)

    def make(n, s):
        r = np.random.RandomState(s)
        toks = np.zeros((n, seq_len), np.int32)
        toks[:, 0] = r.randint(0, vocab_size, n)
        u = r.rand(n, seq_len)
        for t in range(1, seq_len):
            toks[:, t] = np.argmax(
                cum[toks[:, t - 1]] > u[:, t:t + 1], axis=1)
        return toks

    return {'x_train': make(n_train, seed + 1), 'y_train': None,
            'x_valid': make(n_valid, seed + 2), 'y_valid': None}


@register_dataset('digits')
def _digits(fold_csv: Optional[str] = None, fold_number: int = 0,
            valid_fraction: float = 0.2, seed: int = 0, **_):
    """scikit-learn's handwritten digits (1,797 8x8 grayscale scans),
    pixels scaled to [0, 1], NHWC [N, 8, 8, 1]. ``fold_csv`` /
    ``fold_number`` take a fold file (rows in ``load_digits`` order,
    fold == k validates); without one a seeded ``valid_fraction``
    split."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "dataset 'digits' needs scikit-learn, which this Python does "
            "not have; train from an npz of the digits instead") from e
    d = load_digits()
    x = (d.images.astype(np.float32) / 16.0)[..., None]
    y = d.target.astype(np.int32)
    if fold_csv:
        import csv
        with open(fold_csv, newline='') as fh:
            folds = np.asarray([int(row['fold'])
                                for row in csv.DictReader(fh)])
        if len(folds) != len(y):
            raise ValueError(
                f'fold_csv {fold_csv!r} has {len(folds)} rows; expected '
                f'{len(y)} (load_digits order)')
        mask = folds == int(fold_number)
    else:
        rng = np.random.RandomState(seed)
        mask = np.zeros(len(y), bool)
        mask[rng.permutation(len(y))[:int(len(y) * valid_fraction)]] = True
    return {'x_train': x[~mask], 'y_train': y[~mask],
            'x_valid': x[mask], 'y_valid': y[mask],
            'source': 'sklearn.load_digits'}


@register_dataset('synthetic_images')
def _synth_images(n_train: int = 8192, n_valid: int = 1024,
                  image_size: int = 32, channels: int = 3,
                  num_classes: int = 10, seed: int = 0, **_):
    """Class-prototype images + noise — CIFAR-shaped, learnable."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(
        num_classes, image_size, image_size, channels).astype(np.float32)

    def make(n, s):
        r = np.random.RandomState(s)
        y = r.randint(0, num_classes, n)
        x = protos[y] + 0.3 * r.randn(
            n, image_size, image_size, channels).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    xt, yt = make(n_train, seed + 1)
    xv, yv = make(n_valid, seed + 2)
    return {'x_train': xt, 'y_train': yt, 'x_valid': xv, 'y_valid': yv}


@register_dataset('cifar10')
def _cifar10(path: str = None, n_train: int = 50000, n_valid: int = 10000,
             seed: int = 0, **_):
    """CIFAR-10 from a local npz (``path``, ``$CIFAR10_NPZ`` or
    ``<root>/data/cifar10.npz``; keys x_train [N,32,32,3] uint8 or float,
    y_train, x_test, y_test), else a synthetic stand-in with CIFAR's
    shapes and cardinalities."""
    from mlcomp_tpu_torch import DATA_FOLDER
    candidates = [path] if path else []
    candidates.append(os.environ.get('CIFAR10_NPZ'))
    candidates.append(os.path.join(DATA_FOLDER, 'cifar10.npz'))
    for cand in candidates:
        if cand and os.path.exists(cand):
            data = np.load(cand)

            def norm(a):
                a = np.asarray(a, np.float32)
                return a / 255.0 if a.max() > 2.0 else a
            return {'x_train': norm(data['x_train'])[:n_train],
                    'y_train': np.asarray(data['y_train'],
                                          np.int32)[:n_train],
                    'x_valid': norm(data['x_test'])[:n_valid],
                    'y_valid': np.asarray(data['y_test'],
                                          np.int32)[:n_valid],
                    'source': cand}
    out = _synth_images(n_train=n_train, n_valid=n_valid, image_size=32,
                        channels=3, num_classes=10, seed=seed)
    out['source'] = 'synthetic'
    return out


def _not_ported(name: str, item: str):
    def loader(**_):
        raise NotImplementedError(
            f'dataset {name!r} is not ported yet (ROADMAP.md, queue A: '
            f'{item}); ported: npz, synthetic_lm, synthetic_images, '
            f'cifar10, digits')
    register_dataset(name)(loader)


for _name, _item in (('digits_segmentation', 'A7'),
                     ('synthetic_segmentation', 'A7')):
    _not_ported(_name, _item)


# ---------------------------------------------------------------- batching
def iterate_batches(x: np.ndarray, y: Optional[np.ndarray],
                    batch_size: int, rng: Optional[np.random.RandomState]
                    = None, drop_last: bool = True,
                    transform=None, logger=None
                    ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Shuffled host-side batches (the same order as the JAX package's
    for the same ``rng``). Per-sample host transforms are not ported yet
    (augmentation runs on the device: ``device_data``)."""
    if transform is not None:
        raise NotImplementedError(
            'host augment transforms are not ported yet (ROADMAP.md, queue '
            'A: A7); the device-resident path augments pad_crop/hflip/'
            'vflip/cutout')
    n = len(x)
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    dropped = n % batch_size if drop_last else 0
    if dropped and logger is not None:
        logger(f'dropping {dropped} tail samples (n={n} not divisible '
               f'by batch_size={batch_size})')
    end = n - dropped if drop_last else n
    for start in range(0, end, batch_size):
        take = idx[start:start + batch_size]
        yield x[take], (y[take] if y is not None else None)


def _to_device(a: Optional[np.ndarray], device: torch.device):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != 'cuda':
        return t
    # pinned host memory, so the copy can run while the step computes;
    # the caching host allocator keeps the pinned block until it is done
    return t.pin_memory().to(device, non_blocking=True)


def place_batch(batch, device) -> tuple:
    """An (x, y) numpy batch as tensors on ``device``."""
    x, y = batch
    device = torch.device(device)
    return _to_device(x, device), _to_device(y, device)


def prefetch_batches(batch_iter, device, depth: int = 2):
    """Keep ``depth`` batches in flight: the next batches' copies are
    issued before the current one is handed out."""
    buf = deque()
    for batch in batch_iter:
        buf.append(place_batch(batch, device))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


__all__ = ['register_dataset', 'create_dataset', 'resolve_data_paths',
           'iterate_batches', 'prefetch_batches', 'place_batch']

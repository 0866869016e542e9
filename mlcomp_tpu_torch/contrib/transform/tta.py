"""Test-time augmentation — port of ``mlcomp_tpu/contrib/transform/tta.py``.

TTA is a pair of batch-level numpy maps: ``forward`` applied to the
input batch before inference and ``inverse`` applied to the prediction
batch after, so each augmented view is one batched pass on the card. The
flips return views with negative strides; the predictor
(``train/export.py`` ``make_predictor``) makes each batch contiguous
before ``torch.from_numpy``, so the transforms copy nothing.
"""

from typing import Sequence

import numpy as np


class TtaTransform:
    name = 'identity'

    def forward(self, x: np.ndarray) -> np.ndarray:
        return x

    def inverse(self, y: np.ndarray) -> np.ndarray:
        return y


class TtaHFlip(TtaTransform):
    """Flip W on the way in; flip spatial predictions back on the way
    out (scalar/class predictions pass through unchanged)."""
    name = 'hflip'

    def forward(self, x):
        return x[:, :, ::-1] if x.ndim == 4 else x[:, ::-1]

    def inverse(self, y):
        return y[:, :, ::-1] if y.ndim >= 4 else y


class TtaVFlip(TtaTransform):
    name = 'vflip'

    def forward(self, x):
        return x[:, ::-1]

    def inverse(self, y):
        return y[:, ::-1] if y.ndim >= 4 else y


class TtaTranspose(TtaTransform):
    name = 'transpose'

    def forward(self, x):
        return np.swapaxes(x, 1, 2)

    def inverse(self, y):
        return np.swapaxes(y, 1, 2) if y.ndim >= 4 else y


_TTA = {t.name: t for t in (TtaHFlip, TtaVFlip, TtaTranspose)}


def parse_tta(specs: Sequence[str]):
    """['hflip', 'vflip'] -> [identity, TtaHFlip, TtaVFlip]: identity is
    always included so TTA averages over the clean view too."""
    out = [TtaTransform()]
    for s in specs or ():
        out.append(_TTA[s]())
    return out


def tta_predict(predict_fn, x: np.ndarray,
                transforms: Sequence[TtaTransform]) -> np.ndarray:
    """Average predict_fn over all TTA views: mean_t inv_t(f(fwd_t(x)))."""
    acc = None
    for t in transforms:
        y = t.inverse(np.asarray(predict_fn(t.forward(x))))
        acc = y if acc is None else acc + y
    return acc / len(transforms)


__all__ = ['TtaTransform', 'TtaHFlip', 'TtaVFlip', 'TtaTranspose',
           'parse_tta', 'tta_predict']

from mlcomp_tpu_torch.contrib.transform.tta import (
    TtaHFlip, TtaTransform, TtaTranspose, TtaVFlip, parse_tta,
    tta_predict,
)

__all__ = ['TtaTransform', 'TtaHFlip', 'TtaVFlip', 'TtaTranspose',
           'parse_tta', 'tta_predict']

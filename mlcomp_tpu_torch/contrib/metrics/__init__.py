from mlcomp_tpu_torch.contrib.metrics.numpy_metrics import (
    accuracy, confusion_matrix, dice_numpy, f1_macro, iou_numpy,
    per_class_prf,
)

__all__ = ['dice_numpy', 'iou_numpy', 'accuracy', 'f1_macro',
           'per_class_prf', 'confusion_matrix']

from mlcomp_tpu_torch.contrib.criterion.losses import (
    bce_dice, dice_loss, focal_loss, ring_penalty, soft_dice,
)

__all__ = ['dice_loss', 'focal_loss', 'bce_dice', 'ring_penalty',
           'soft_dice']

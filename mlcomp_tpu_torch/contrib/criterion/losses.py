"""Extra training criteria — port of
``mlcomp_tpu/contrib/criterion/losses.py``: the segmentation losses
``dice``, ``bce_dice`` and ``focal`` under the trainer's
``(logits, labels, weights=None) -> (loss, metrics)`` contract, and the
ring-loss term.

They register into ``train.loop.LOSSES`` (``setdefault``) when this
module is imported, which ``loss_for_task`` does on a name it does not
know, as the JAX package does. Labels follow the rules of the JAX
functions they mirror: the cross-entropy of ``bce_dice`` and ``focal``'s
``take_along_axis`` wrap a label in [-C, 0) to label + C and give NaN
for one outside [-C, C) (``loop._ce``, optax's rule); the dice's one-hot
(``jnp.eye(C)[labels]``) wraps the negatives and clamps the rest into
[0, C).
"""

import torch

from mlcomp_tpu_torch.train.loop import LOSSES, _ce, _weighted


def _one_hot_probs(logits, labels):
    logits = logits.float()
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    c = logits.shape[-1]
    labels = labels.long()
    index = torch.where(labels < 0, labels + c, labels).clamp(0, c - 1)
    onehot = torch.eye(c, dtype=torch.float32, device=logits.device)[index]
    return probs, onehot


def soft_dice(logits, labels, eps: float = 1e-6):
    """Per-example soft dice over [B, H, W, C] logits vs [B, H, W] labels,
    averaged over classes. Returns [B]."""
    probs, onehot = _one_hot_probs(logits, labels)
    axes = tuple(range(1, probs.dim() - 1))
    inter = (probs * onehot).sum(axes)
    union = probs.sum(axes) + onehot.sum(axes)
    dice = (2 * inter + eps) / (union + eps)
    return dice.mean(-1)


def _pixel_accuracy(logits, labels):
    correct = (logits.argmax(-1) == labels).float()
    return correct.mean(tuple(range(1, labels.dim())))


def dice_loss(logits, labels, weights=None):
    dice = soft_dice(logits, labels)
    correct = _pixel_accuracy(logits, labels)
    loss, acc = _weighted(1.0 - dice, correct, weights)
    d, _ = _weighted(dice, correct, weights)
    return loss, {'loss': loss, 'dice': d, 'accuracy': acc}


def bce_dice(logits, labels, weights=None, dice_weight: float = 0.5):
    """Cross-entropy + dice blend: CE for gradient conditioning early,
    dice for the IoU target."""
    per_ce = _ce(logits, labels)
    per_ce = per_ce.mean(tuple(range(1, per_ce.dim())))
    dice = soft_dice(logits, labels)
    per = (1 - dice_weight) * per_ce + dice_weight * (1.0 - dice)
    correct = _pixel_accuracy(logits, labels)
    loss, acc = _weighted(per, correct, weights)
    d, _ = _weighted(dice, correct, weights)
    return loss, {'loss': loss, 'dice': d, 'accuracy': acc}


def focal_loss(logits, labels, weights=None, gamma: float = 2.0):
    """Focal CE for class imbalance: (1 - p_t)^gamma * -log p_t."""
    logp = logits.float()
    top = logp.amax(-1, keepdim=True)
    logp = logp - torch.log(torch.exp(logp - top).sum(-1, keepdim=True)) \
        - top
    c = logp.shape[-1]
    labels = labels.long()
    wrapped = torch.where(labels < 0, labels + c, labels)
    index = wrapped.clamp(0, c - 1).unsqueeze(-1)
    logpt = logp.gather(-1, index).squeeze(-1)
    in_range = (wrapped >= 0) & (wrapped < c)
    logpt = torch.where(in_range, logpt, torch.full_like(logpt, float('nan')))
    pt = torch.exp(logpt)
    per = -((1.0 - pt) ** gamma) * logpt
    if per.dim() > 1:
        per = per.mean(tuple(range(1, per.dim())))
    correct = logits.argmax(-1) == labels
    if correct.dim() > 1:
        correct = correct.float().mean(tuple(range(1, correct.dim())))
    loss, acc = _weighted(per, correct, weights)
    return loss, {'loss': loss, 'accuracy': acc}


def ring_penalty(features, radius):
    """Ring-loss term: pulls the feature vectors' L2 norms toward a
    learnable radius. Add to a main loss:
    ``loss + weight * ring_penalty(feats, radius)``."""
    norms = torch.linalg.vector_norm(
        features.float().reshape(features.shape[0], -1), dim=-1)
    return ((norms - radius) ** 2).mean()


LOSSES.setdefault('dice', dice_loss)
LOSSES.setdefault('bce_dice', bce_dice)
LOSSES.setdefault('focal', focal_loss)

__all__ = ['dice_loss', 'bce_dice', 'focal_loss', 'soft_dice',
           'ring_penalty']

"""Losses, train state and the train/eval steps — port of
``mlcomp_tpu/train/loop.py`` (single device; no mesh).

bf16 policy as in the JAX package: params and optimizer state stay f32,
the compute dtype comes from the model (``dtype='bfloat16'``), losses
and metrics reduce in f32. A step runs eagerly: the model's forward with
``train=True``, ``torch.autograd.grad`` of the loss (through the flash
backward kernels on the card), the optimizer's update and its in-place
application. Metrics stay on the device as 0-d tensors until
``aggregate_metrics`` pulls a whole epoch's in one transfer.

Running statistics (``batch_stats`` in the JAX package) are the model's
buffers: a train-mode forward updates them in place, as ``_apply``'s
mutable ``batch_stats`` does, and the eval step reads them. The
device-resident data steps (``make_device_train_step`` /
``make_device_eval_step``) take the whole dataset on the device and an
index vector.

Not ported yet: the MoE auxiliary loss (``MOE_AUX_COEF`` and the
``intermediates`` collection wait with MoE), ``make_device_epoch_fn``
(one dispatch per epoch) and ``instrumented_step`` (telemetry, ROADMAP
A6).
"""

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from mlcomp_tpu_torch.ops.fused_ce import softmax_ce_per_example
from mlcomp_tpu_torch.train.optim import apply_updates


@dataclasses.dataclass
class TrainState:
    """What ``flax``'s TrainState holds, the PyTorch way: the parameters
    and running statistics live in ``model`` (updated in place by each
    step), ``opt_state`` is the optimizer's state over the parameters,
    ``rng`` the dropout seed (None: no dropout randomness)."""
    step: int
    model: nn.Module
    opt_state: Any
    rng: Optional[int] = None

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Optional[dict]:
        """The model's running statistics (its buffers), or None."""
        return dict(self.model.named_buffers()) or None


# ------------------------------------------------------------------ losses
# Every loss takes optional per-example weights [B] (1=count, 0=ignore).
def _weighted(per_example, correct, weights):
    if weights is None:
        return per_example.mean(), correct.float().mean()
    w = weights.float()
    n = w.sum().clamp_min(1.0)
    return (per_example * w).sum() / n, (correct.float() * w).sum() / n


def _ce(logits, labels):
    """optax's ``softmax_cross_entropy_with_integer_labels`` in f32 over
    the last axis."""
    logits = logits.float()
    picked = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def softmax_ce(logits, labels, weights=None):
    per = _ce(logits, labels)
    correct = logits.argmax(-1) == labels
    loss, acc = _weighted(per, correct, weights)
    return loss, {'loss': loss, 'accuracy': acc}


def lm_ce(logits, tokens, weights=None):
    """Next-token cross-entropy: logits [B,T,V] vs tokens [B,T]."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    per = _ce(logits, targets).mean(-1)
    correct = (logits.argmax(-1) == targets).float().mean(-1)
    loss, acc = _weighted(per, correct, weights)
    return loss, {'loss': loss, 'accuracy': acc}


def seg_ce(logits, labels, weights=None):
    """Pixel cross-entropy: logits [B,H,W,C] vs labels [B,H,W]."""
    per = _ce(logits, labels).mean((-2, -1))
    correct = (logits.argmax(-1) == labels).float().mean((-2, -1))
    loss, acc = _weighted(per, correct, weights)
    return loss, {'loss': loss, 'accuracy': acc}


def lm_ce_with(z_loss: float = 0.0, label_smoothing: float = 0.0,
               impl: str = 'auto') -> Callable:
    """lm_ce with z-loss / label smoothing through
    ``ops/fused_ce.py``'s ``softmax_ce_per_example``: ``impl`` ``auto``
    (the default) or ``cuda`` (a JAX config's ``pallas``) runs the
    hand-written CE kernels (``csrc/fused_ce.cu``: one forward and one
    backward launch a step) on the card and their plain versions on the
    CPU; ``dense`` the dense formulation. At batch 1 the kernels read
    ``logits[:, :-1]`` in place; the accuracy's ``argmax`` of the f32
    logits stays outside them, as in the JAX package."""

    def loss_fn(logits, tokens, weights=None):
        lg = logits[:, :-1]
        targets = tokens[:, 1:]
        b, t, v = lg.shape
        per_tok = softmax_ce_per_example(
            lg.reshape(b * t, v), targets.reshape(-1), impl=impl,
            z_loss=z_loss, label_smoothing=label_smoothing,
        ).reshape(b, t)
        per = per_tok.mean(-1)
        correct = (lg.float().argmax(-1) == targets).float().mean(-1)
        loss, acc = _weighted(per, correct, weights)
        return loss, {'loss': loss, 'accuracy': acc}

    return loss_fn


LOSSES = {'softmax_ce': softmax_ce, 'lm_ce': lm_ce, 'seg_ce': seg_ce}


def loss_for_task(task) -> Callable:
    """``task``: a registered loss name, or a dict spec — e.g.
    ``{name: lm_ce, impl: pallas, z_loss: 1e-4, label_smoothing: 0.1}``
    builds ``lm_ce_with`` (the fused-CE lm loss)."""
    if isinstance(task, dict):
        spec = dict(task)
        name = spec.pop('name', None)
        if name == 'lm_ce' and spec:
            allowed = {'z_loss', 'label_smoothing', 'impl'}
            unknown = set(spec) - allowed
            if unknown:
                raise ValueError(
                    f'unknown lm_ce options {sorted(unknown)}; '
                    f'allowed: {sorted(allowed)}')
            return lm_ce_with(**spec)
        if spec:
            raise ValueError(
                f'loss options are supported for lm_ce only, '
                f'got {task!r}')
        task = name
    if task not in LOSSES:
        raise KeyError(
            f'unknown loss {task!r}; have {sorted(LOSSES)} (the contrib '
            f'losses dice/bce_dice/focal are not ported yet: ROADMAP.md, '
            f'queue A: A7)')
    return LOSSES[task]


# ------------------------------------------------------------------- steps
def _step_generator(state: TrainState) -> Optional[torch.Generator]:
    """This step's dropout randomness: the run's seed folded with the
    step (``jax.random.fold_in(rng, step)``'s role)."""
    if state.rng is None:
        return None
    return torch.Generator().manual_seed(
        (int(state.rng) * 1_000_003 + int(state.step)) % (2 ** 63))


def make_train_step(model, optimizer, loss_fn: Callable,
                    self_supervised: bool = False):
    """``step(state, x, y) -> (state, metrics)``: one optimizer step on
    the batch; ``state`` is updated in place and returned.

    ``self_supervised``: y is ignored, the loss sees (logits, x) — the
    LM case where inputs are also targets."""

    def step(state: TrainState, x, y):
        logits = state.model(x, train=True,
                             generator=_step_generator(state))
        loss, metrics = loss_fn(logits, x if self_supervised else y)
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, state.opt_state = optimizer.update(
            dict(zip(params, grads)), state.opt_state, params)
        apply_updates(params, updates)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def _augment_seed(state: TrainState) -> int:
    """This step's augmentation seed: the dropout seed (0 without one)
    folded with the step, so the crop and flip pattern changes every
    step and epoch."""
    seed = 0 if state.rng is None else int(state.rng)
    return (seed * 1_000_003 + int(state.step)) * 2 + 1


def make_device_train_step(model, optimizer, loss_fn: Callable,
                           augment=None, dequantize: bool = False):
    """``step(state, x_all, y_all, idx) -> (state, metrics)`` over a
    dataset already on the device: the batch is gathered by the [B]
    index vector there, augmented (``device_data.make_device_augment``,
    on the stored pixels, before dequantization) and, for a uint8-packed
    dataset, dequantized to f32 in [0, 1]."""
    inner = make_train_step(model, optimizer, loss_fn)
    generators = {}        # one per device, reseeded every step

    def step(state: TrainState, x_all, y_all, idx):
        x = x_all.index_select(0, idx)
        y = y_all.index_select(0, idx)
        if augment is not None:
            gen = generators.get(x.device)
            if gen is None:
                gen = generators[x.device] = torch.Generator(x.device)
            x = augment(x, gen.manual_seed(_augment_seed(state)))
        if dequantize:
            x = x.float() / 255.0
        return inner(state, x, y)

    return step


def make_device_eval_step(model, loss_fn: Callable,
                          dequantize: bool = False):
    """``step(state, x_all, y_all, idx, w) -> metrics`` against the
    device-resident validation set."""
    inner = make_eval_step(model, loss_fn)

    def step(state: TrainState, x_all, y_all, idx, w=None):
        x = x_all.index_select(0, idx)
        if dequantize:
            x = x.float() / 255.0
        return inner(state, x, y_all.index_select(0, idx), w)

    return step


def make_eval_step(model, loss_fn: Callable, self_supervised: bool = False):
    """``step(state, x, y, w=None) -> metrics`` without gradients."""

    @torch.inference_mode()
    def step(state: TrainState, x, y, w=None):
        logits = state.model(x)
        _, metrics = loss_fn(logits, x if self_supervised else y,
                             weights=w)
        return metrics

    return step


def aggregate_metrics(metrics_list, weights=None):
    """Mean (optionally weighted) of a list of per-step metric dicts,
    pulled from the device in ONE transfer."""
    if not metrics_list:
        return {}
    keys = sorted(metrics_list[0])
    stacked = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                        for m in metrics_list])
                           for k in keys])
    values = stacked.cpu().numpy()        # single device→host transfer
    if weights is not None:
        w = np.asarray(weights, np.float64)
        return {k: float(np.average(values[i], weights=w))
                for i, k in enumerate(keys)}
    return {k: float(values[i].mean()) for i, k in enumerate(keys)}


def create_train_state(model, optimizer, seed: Optional[int] = 0,
                       with_dropout_rng: bool = False) -> TrainState:
    """The state of a fresh run: ``model`` as initialised (the port's
    models draw their weights from a generator at construction), the
    optimizer's initial state over its parameters and, with
    ``with_dropout_rng``, ``seed`` for the dropout masks."""
    return TrainState(
        step=0, model=model,
        opt_state=optimizer.init(dict(model.named_parameters())),
        rng=int(seed or 0) if with_dropout_rng else None)


__all__ = ['TrainState', 'make_train_step', 'make_eval_step',
           'make_device_train_step', 'make_device_eval_step',
           'aggregate_metrics', 'create_train_state', 'loss_for_task',
           'LOSSES', 'softmax_ce', 'lm_ce', 'seg_ce', 'lm_ce_with']

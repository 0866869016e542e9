"""Valid executors — port of ``mlcomp_tpu/worker/executors/valid.py``.

``Valid`` is the scoring harness over Equation parts; it returns the
final score and, with a DB session, writes it to ``task.score`` and the
model's ``score_local``. Report images wait for an image encoder on the
card (ROADMAP.md, A0): ``plot`` and ``plot_final`` do nothing. ``ValidClassify`` scores class
probabilities (or labels) against a labelled dataset by ``accuracy`` or
``f1_macro``; ``ValidSegment`` scores masks by foreground ``iou`` or
``dice``. Both are numpy over what ``load()`` (or ``infer()``) gives.
"""

import numpy as np

from mlcomp_tpu_torch.contrib.metrics import (
    dice_numpy, f1_macro, iou_numpy,
)
from mlcomp_tpu_torch.worker.executors.base.equation import Equation
from mlcomp_tpu_torch.worker.executors.base.executor import Executor
from mlcomp_tpu_torch.worker.executors.dataset_input import (
    DatasetInputMixin,
)


@Executor.register
class Valid(Equation):
    def __init__(self, layout: str = None, fold_number: int = 0,
                 plot_count: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.layout = layout
        self.fold_number = int(fold_number)
        self.plot_count = int(plot_count)

    def key(self) -> str:
        return 'y'

    def score(self, preds) -> float:
        raise NotImplementedError

    def score_final(self) -> float:
        raise NotImplementedError

    def plot(self, preds, score):
        """Per-part report hook: report images wait (ROADMAP.md, A0)."""

    def plot_final(self, score):
        """Whole-set report hook: report images wait (ROADMAP.md, A0)."""

    def work(self):
        self._check_device()
        self.create_base()
        parts = self.generate_parts(self.count())
        for preds in self.solve(self.key(), parts):
            score = self.score(preds)
            if self.layout and self.plot_count > 0:
                self.plot(preds, score)
        final = self.score_final()
        final = -1.0 if final is None or np.isnan(final) else float(final)
        if self.layout:
            self.plot_final(final)
        self._write_scores(final)
        return {'score': final}

    def _write_scores(self, score: float):
        """task.score and, for a registered model, its score_local."""
        if self.session is None:
            return
        from mlcomp_tpu_torch.db.providers import ModelProvider, TaskProvider
        if self.task is not None:
            self.task.score = score
            TaskProvider(self.session).update(self.task, ['score'])
        model_name = self._resolve_model_name()
        if self.model_id or model_name:
            provider = ModelProvider(self.session)
            row = provider.by_id(self.model_id) if self.model_id \
                else provider.by_name(model_name)
            if row is not None:
                row.score_local = score
                provider.update(row, ['score_local'])


@Executor.register
class ValidClassify(DatasetInputMixin, Valid):
    """Accuracy/F1 of class-probability predictions vs dataset labels.

    Config::

        valid:
          type: valid_classify
          dataset: {path: d.npz, fold_csv: fold.csv, fold_number: 0}
          y: load('my_model')           # or an ensemble expression
          metric: accuracy              # or f1_macro
    """

    def __init__(self, y: str = None, metric: str = 'accuracy',
                 class_names=None, **kwargs):
        super().__init__(**kwargs)
        self.y = y or "load()"
        self.metric = metric
        self.class_names = class_names
        self._correct = 0
        self._f1_true = []
        self._f1_pred = []
        self._seen = 0

    def create_base(self):
        self.x, self.y_true = self.load_dataset_arrays(part='valid')
        if self.y_true is None:
            raise ValueError('valid_classify needs a labeled dataset')

    def score(self, preds) -> float:
        preds = np.asarray(preds)
        labels = preds.argmax(-1) if preds.ndim > 1 else preds
        lo, hi = self.part
        truth = self.y_true[lo:hi if hi is not None else len(self.y_true)]
        labels = labels[:len(truth)]
        self._correct += int((labels == truth).sum())
        self._seen += len(truth)
        self._f1_true.append(truth)
        self._f1_pred.append(labels)
        return float((labels == truth).mean()) if len(truth) else 0.0

    def score_final(self) -> float:
        if self._seen == 0:
            return float('nan')
        if self.metric == 'f1_macro':
            return f1_macro(np.concatenate(self._f1_true),
                            np.concatenate(self._f1_pred))
        return self._correct / self._seen


@Executor.register
class ValidSegment(DatasetInputMixin, Valid):
    """Foreground IoU / dice of mask predictions vs dataset masks.

    Config::

        valid:
          type: valid_segment
          dataset: {path: masks.npz}
          y: (load('unet_a') + load('unet_b')) / 2   # prob ensembles
          metric: iou                                 # or dice
    """

    def __init__(self, y: str = None, metric: str = 'iou', **kwargs):
        super().__init__(**kwargs)
        self.y = y or "load()"
        self.metric = metric
        if metric not in ('iou', 'dice'):
            raise ValueError(f"metric must be 'iou' or 'dice', "
                             f'got {metric!r}')
        self._inter = 0
        self._union = 0
        self._sum_true = 0
        self._sum_pred = 0

    def create_base(self):
        self.x, self.y_true = self.load_dataset_arrays(part='valid')
        if self.y_true is None:
            raise ValueError('valid_segment needs a mask-labeled '
                             'dataset')

    def _labels(self, preds) -> np.ndarray:
        preds = np.asarray(preds)
        # [n, H, W, C] class probabilities -> argmax; [n, H, W] ids
        return preds.argmax(-1) if preds.ndim == 4 else preds

    def score(self, preds) -> float:
        labels = self._labels(preds)
        lo, hi = self.part
        truth = self.y_true[lo:hi if hi is not None
                            else len(self.y_true)]
        labels = labels[:len(truth)]
        t = np.asarray(truth) > 0        # foreground vs background
        p = np.asarray(labels) > 0
        self._inter += int(np.logical_and(t, p).sum())
        self._union += int(np.logical_or(t, p).sum())
        self._sum_true += int(t.sum())
        self._sum_pred += int(p.sum())
        fn = iou_numpy if self.metric == 'iou' else dice_numpy
        return fn(t, p)

    def score_final(self) -> float:
        if self.metric == 'dice':
            denom = self._sum_true + self._sum_pred
            return 1.0 if denom == 0 else 2.0 * self._inter / denom
        return 1.0 if self._union == 0 else self._inter / self._union


__all__ = ['Valid', 'ValidClassify', 'ValidSegment']

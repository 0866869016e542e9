"""Infer executors — port of ``mlcomp_tpu/worker/executors/infer.py``.

``Infer`` is the prediction harness over Equation parts: ``create_base``
loads the input, each part's equation is solved and saved, then
``save_final``. ``InferClassify`` runs the ``y`` equation (by default,
inference of this executor's model export on the card) over a dataset
and saves ``data/pred/<name>.npy`` for the Valid and ensemble stages
downstream.
"""

import os

import numpy as np

from mlcomp_tpu_torch.worker.executors.base.equation import (
    Equation, PRED_FOLDER,
)
from mlcomp_tpu_torch.worker.executors.base.executor import Executor
from mlcomp_tpu_torch.worker.executors.dataset_input import (
    DatasetInputMixin,
)


@Executor.register
class Infer(Equation):
    def __init__(self, test: bool = False, layout: str = None,
                 plot_count: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.test = test
        self.layout = layout
        self.plot_count = int(plot_count)

    def key(self) -> str:
        return 'y'

    def plot(self, preds):
        """Optional per-part report hook (wired by report builders)."""

    def save(self, preds, folder: str):
        raise NotImplementedError

    def save_final(self, folder: str):
        pass

    def work(self):
        self._check_device()
        os.makedirs(PRED_FOLDER, exist_ok=True)
        self.create_base()
        parts = self.generate_parts(self.count())
        for preds in self.solve(self.key(), parts):
            self.save(preds, PRED_FOLDER)
            if self.layout:
                self.plot(preds)
        self.save_final(PRED_FOLDER)
        return {'count': self.count(), 'name': self.name}


@Executor.register
class InferClassify(DatasetInputMixin, Infer):
    """Predict a classification dataset with a model export.

    Config::

        infer:
          type: infer_classify
          model_name: my_model          # models/my_model.msgpack
          dataset: {path: d.npz, fold_csv: fold.csv, fold_number: 0}
          # y defaults to inference on the card; override for ensembles:
          # y: (load('a') + load('b')) / 2
          device: cuda                  # the default; cpu to ask for it
    """

    def __init__(self, y: str = None, batch_size: int = 512,
                 activation: str = 'softmax', tta=(), **kwargs):
        super().__init__(**kwargs)
        self.batch_size = int(batch_size)
        self.activation = activation
        self.tta_specs = list(tta)
        self.y = y or self._default_equation()
        self._chunks = []

    def _default_equation(self):
        tta = f', tta={self.tta_specs!r}' if self.tta_specs else ''
        return (f'infer(batch_size={self.batch_size}, '
                f'activation={self.activation!r}{tta})')

    def create_base(self):
        self.x, self.y_true = self.load_dataset_arrays(
            part='test' if self.test else 'valid')

    def save(self, preds, folder: str):
        self._chunks.append(np.asarray(preds))

    def save_final(self, folder: str):
        out = np.concatenate(self._chunks) if self._chunks \
            else np.empty(0)
        name = self.name or self._resolve_model_name() or 'pred'
        path = os.path.join(folder, f'{name}.npy')
        np.save(path, out)
        self.info(f'saved predictions {out.shape} -> {path}')


__all__ = ['Infer', 'InferClassify']

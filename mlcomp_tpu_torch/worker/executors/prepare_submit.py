"""PrepareSubmit executors — port of
``mlcomp_tpu/worker/executors/prepare_submit.py``.

The submission-file builder at the end of a train -> infer -> ensemble
pipe: the ``y`` equation is solved part by part and the rows go to
``data/submissions/``. ``SubmitClassify`` writes the ``id,label`` csv of
class probabilities' argmax (``utils/csv_io``, as pandas writes it).
"""

import os

import numpy as np

from mlcomp_tpu_torch.utils.csv_io import write_csv
from mlcomp_tpu_torch.worker.executors.base.equation import Equation
from mlcomp_tpu_torch.worker.executors.base.executor import Executor
from mlcomp_tpu_torch.worker.executors.dataset_input import (
    DatasetInputMixin,
)

SUBMIT_FOLDER = os.path.join('data', 'submissions')


@Executor.register
class PrepareSubmit(Equation):
    def __init__(self, layout: str = None, plot_count: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.layout = layout
        self.plot_count = int(plot_count)

    def key(self) -> str:
        return 'y'

    def plot(self, preds):
        pass

    def submit(self, preds):
        raise NotImplementedError

    def submit_final(self, folder: str):
        pass

    def work(self):
        os.makedirs(SUBMIT_FOLDER, exist_ok=True)
        self.create_base()
        parts = self.generate_parts(self.count())
        for preds in self.solve(self.key(), parts):
            self.submit(preds)
            if self.layout:
                self.plot(preds)
        self.submit_final(SUBMIT_FOLDER)
        return {'folder': SUBMIT_FOLDER}


@Executor.register
class SubmitClassify(DatasetInputMixin, PrepareSubmit):
    """Write ``<out>.csv`` with ``id,label`` from probability predictions.

    Config::

        submit:
          type: submit_classify
          dataset: {path: test.npz}
          y: (load('a') + load('b')) / 2
          out: submission
          id_column: id
          label_column: label
    """

    def __init__(self, y: str = None, out: str = 'submission',
                 id_column: str = 'id', label_column: str = 'label',
                 **kwargs):
        super().__init__(**kwargs)
        self.y = y or "load()"
        self.out = out
        self.id_column = id_column
        self.label_column = label_column
        self._labels = []

    def create_base(self):
        self.x, self.y_true = self.load_dataset_arrays(part='test')

    def submit(self, preds):
        preds = np.asarray(preds)
        self._labels.append(
            preds.argmax(-1) if preds.ndim > 1 else preds)

    def submit_final(self, folder: str):
        labels = np.concatenate(self._labels) if self._labels \
            else np.empty(0, np.int64)
        path = os.path.join(folder, f'{self.out}.csv')
        write_csv(path, {self.id_column: np.arange(len(labels)),
                         self.label_column: labels})
        self.info(f'wrote submission ({len(labels)} rows) -> {path}')


__all__ = ['PrepareSubmit', 'SubmitClassify', 'SUBMIT_FOLDER']

"""Split executor — port of ``mlcomp_tpu/worker/executors/split.py``.

Writes a ``fold.csv`` into the project's data folder from a label csv
(``variant: frame``), a group column (``group`` / ``stratified_group``)
or a plain sample count (``count``): the fold file that a dataset's
``fold_csv`` filter reads. The csv is read and written with
``utils/csv_io`` as pandas reads and writes it: the input's columns,
then ``fold``.
"""

import os

import numpy as np

from mlcomp_tpu_torch.utils.csv_io import n_rows, read_csv, write_csv
from mlcomp_tpu_torch.worker.executors.base.executor import Executor


@Executor.register
class Split(Executor):
    def __init__(self, variant: str = 'frame', out: str = 'fold.csv',
                 n_splits: int = 5, file: str = None, label: str = None,
                 group_column: str = None, count: int = None,
                 seed: int = 0):
        self.variant = variant
        self.out = out
        self.n_splits = int(n_splits)
        self.file = file
        self.label = label
        self.group_column = group_column
        self.count = count
        self.seed = int(seed)

    @classmethod
    def _parse_config(cls, executor_spec, config, additional_info):
        kwargs = super()._parse_config(executor_spec, config,
                                       additional_info)
        folder = config.data_folder
        os.makedirs(folder, exist_ok=True)
        if kwargs.get('file'):
            kwargs['file'] = os.path.join(folder, kwargs['file'])
        kwargs['out'] = os.path.join(folder, kwargs.get('out', 'fold.csv'))
        return kwargs

    def work(self):
        from mlcomp_tpu_torch.contrib.split import (
            group_k_fold, stratified_group_k_fold, stratified_k_fold,
        )
        if self.variant == 'frame':
            columns = read_csv(self.file)
            fold = stratified_k_fold(self.label, df=columns,
                                     n_splits=self.n_splits,
                                     seed=self.seed)
        elif self.variant == 'group':
            columns = read_csv(self.file)
            fold = group_k_fold(self.group_column, df=columns,
                                n_splits=self.n_splits, seed=self.seed)
        elif self.variant == 'stratified_group':
            columns = read_csv(self.file)
            fold = stratified_group_k_fold(
                self.label, group_column=self.group_column, df=columns,
                n_splits=self.n_splits, seed=self.seed)
        elif self.variant == 'count':
            # unlabeled data: uniform random folds over `count` samples
            rng = np.random.RandomState(self.seed)
            fold = rng.randint(0, self.n_splits, int(self.count))
            columns = {}
        else:
            raise ValueError(f'unknown split variant {self.variant!r}')
        columns['fold'] = fold
        write_csv(self.out, columns)
        rows = n_rows(columns)
        self.info(f'wrote {self.out}: {rows} rows, '
                  f'{self.n_splits} folds')
        return {'rows': rows, 'out': self.out}


__all__ = ['Split']

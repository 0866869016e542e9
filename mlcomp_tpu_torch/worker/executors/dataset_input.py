"""Dataset loading for the Equation executors — port of
``mlcomp_tpu/worker/executors/dataset_input.py``.

A ``dataset:`` spec in the executor config resolves to dense arrays:

- ``{name: synthetic_images, ...}``: a registered loader of the port's
  ``train/data.py`` (``part`` selects the train or valid split);
- ``{path: d.npz, fold_csv: fold.csv, fold_number: 0}``: a fold-filtered
  array file (``contrib.dataset.NpzDataset``);
- ``{img_folder: ..., fold_csv: ...}``: an image folder of PNG or NPY
  files (``contrib.dataset.ImageDataset``).

Bare file names resolve against ``data/`` (``train/data.py``'s
``resolve_data_paths``).
"""

from mlcomp_tpu_torch.train.data import create_dataset, resolve_data_paths


class DatasetInputMixin:
    """Sets ``self.x`` / ``self.y_true`` from ``self.dataset``."""

    def load_dataset_arrays(self, part: str = 'valid'):
        spec = dict(getattr(self, 'dataset', None) or {})
        if not spec:
            raise ValueError(f'{type(self).__name__} needs a dataset: spec')
        if 'name' in spec:
            data = create_dataset(**spec)
            if part == 'train':
                return data['x_train'], data['y_train']
            return data['x_valid'], data['y_valid']
        if 'img_folder' in spec:
            from mlcomp_tpu_torch.contrib.dataset import ImageDataset
            spec.setdefault('is_test', part != 'train')
            return ImageDataset(**resolve_data_paths(spec)).arrays()
        if 'path' in spec:
            from mlcomp_tpu_torch.contrib.dataset import NpzDataset
            spec.setdefault('is_test', part != 'train')
            return NpzDataset(**resolve_data_paths(spec)).arrays()
        raise ValueError(f'cannot interpret dataset spec {sorted(spec)}')


__all__ = ['DatasetInputMixin']

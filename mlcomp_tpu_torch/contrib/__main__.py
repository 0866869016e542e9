"""Contrib command line — port of ``mlcomp_tpu/contrib/__main__.py``
(argparse for click, ``utils/csv_io`` for pandas; it imports no torch):
fold-file generators for the standard dataset layouts.

- ``split-classify IMG_PATH N [--group-regex R] [--out fold.csv]`` —
  class-per-subfolder layout -> ``fold.csv`` (image, label, fold),
  stratified; ``--group-regex`` keeps same-group images in one fold
- ``split-segment IMG_PATH MASK_PATH N [--out fold.csv]`` — image and
  mask folders -> ``fold.csv`` (image, mask, fold)
- ``split-frame CSV LABEL N [--out fold.csv]`` — any csv with a label
  column
- ``split-test-img IMG_PATH [--out fold_test.csv]`` — a test folder ->
  a single-fold ``fold_test.csv``

``image`` holds the file's name alone, without its class folder. An
error prints ``Error: ...`` and exits 1, as the JAX package's click
commands do.
"""

import argparse
import os
import re
import sys
from uuid import uuid4

import numpy as np

from mlcomp_tpu_torch.utils.csv_io import n_rows, read_csv, write_csv


class CommandError(Exception):
    """Printed as ``Error: ...``, exit 1."""


def split_classify(img_path, n_splits, group_regex=None, out='fold.csv'):
    from mlcomp_tpu_torch.contrib.split import (
        stratified_group_k_fold, stratified_k_fold,
    )
    rows = [(img, sub)
            for sub in sorted(os.listdir(img_path))
            if os.path.isdir(os.path.join(img_path, sub))
            for img in sorted(os.listdir(os.path.join(img_path, sub)))]
    if not rows:
        raise CommandError(f'no class subfolders in {img_path}')
    columns = {'image': [r[0] for r in rows],
               'label': np.asarray([r[1] for r in rows], dtype=object)}
    if group_regex:
        pattern = re.compile(group_regex)

        def group_of(name):
            m = pattern.match(name)
            return m.group(1) if m else str(uuid4())

        groups = [group_of(img) for img in columns['image']]
        columns['fold'] = stratified_group_k_fold(
            columns['label'], groups=groups, n_splits=n_splits)
    else:
        columns['fold'] = stratified_k_fold(columns['label'],
                                            n_splits=n_splits)
    write_csv(out, columns)
    print(f'wrote {out}: {len(rows)} rows, {n_splits} folds')


def split_segment(img_path, mask_path, n_splits, out='fold.csv'):
    images = sorted(os.listdir(img_path))
    masks = {os.path.splitext(m)[0]: m
             for m in sorted(os.listdir(mask_path))}
    rows = []
    for img in images:
        stem = os.path.splitext(img)[0]
        if stem in masks:
            rows.append((img, masks[stem]))
    if not rows:
        raise CommandError('no image/mask pairs found')
    rng = np.random.RandomState(0)
    write_csv(out, {'image': [r[0] for r in rows],
                    'mask': [r[1] for r in rows],
                    'fold': rng.permutation(len(rows)) % n_splits})
    print(f'wrote {out}: {len(rows)} rows, {n_splits} folds')


def split_test_img(img_path, out='fold_test.csv'):
    images = sorted(
        f for f in os.listdir(img_path)
        if os.path.isfile(os.path.join(img_path, f)))
    if not images:
        raise CommandError(f'no files in {img_path}')
    write_csv(out, {'image': images, 'fold': [0] * len(images)})
    print(f'wrote {out}: {len(images)} rows')


def split_frame(csv_path, label, n_splits, out='fold.csv'):
    from mlcomp_tpu_torch.contrib.split import stratified_k_fold
    columns = read_csv(csv_path)
    columns['fold'] = stratified_k_fold(label, df=columns,
                                        n_splits=n_splits)
    write_csv(out, columns)
    print(f'wrote {out}: {n_rows(columns)} rows, {n_splits} folds')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='python -m mlcomp_tpu_torch.contrib')
    sub = parser.add_subparsers(dest='command', required=True)
    p = sub.add_parser('split-classify')
    p.add_argument('img_path')
    p.add_argument('n_splits', type=int)
    p.add_argument('--group-regex', default=None,
                   help='regex whose group(1) defines the fold-group')
    p.add_argument('--out', default='fold.csv')
    p = sub.add_parser('split-segment')
    p.add_argument('img_path')
    p.add_argument('mask_path')
    p.add_argument('n_splits', type=int)
    p.add_argument('--out', default='fold.csv')
    p = sub.add_parser('split-test-img')
    p.add_argument('img_path')
    p.add_argument('--out', default='fold_test.csv')
    p = sub.add_parser('split-frame')
    p.add_argument('csv_path')
    p.add_argument('label')
    p.add_argument('n_splits', type=int)
    p.add_argument('--out', default='fold.csv')
    return parser


def main(argv=None) -> int:
    args = vars(build_parser().parse_args(argv))
    command = {'split-classify': split_classify,
               'split-segment': split_segment,
               'split-test-img': split_test_img,
               'split-frame': split_frame}[args.pop('command')]
    try:
        command(**args)
    except CommandError as e:
        print(f'Error: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())

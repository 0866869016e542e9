"""Grid-search cell expansion (parity: reference contrib/search/grid.py:19-62).

A grid spec is a list of axes. Axis forms:
- ``{param: [v1, v2]}``         — one dict with a list value: each value is
                                   a cell option ``{param: v}``
- ``[{...}, {...}]``             — explicit list of option dicts
- ``{_file: [a.yml, b.yml]}``    — each yml file's content is an option
- ``{_folder: path}``            — every ``*.yml`` in the folder is an option

Cells are the cartesian product of all axes; each cell is the merged dict
of its options, paired with a human-readable name (the flattened ``k=v``
string, reference grid.py:10-16). Large cells are truncated to the last
300 chars with a short stable hash of the FULL flattened cell appended:
the reference's bare tail truncation gave two cells differing only in
EARLY params identical names in the dashboard/CLI, so a sweep's verdict
table could not tell them apart. The hash suffix rides at the END so
downstream tail-preserving truncations (task names) keep it.
"""

import hashlib

from glob import glob
from itertools import product
from os.path import join

from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.utils.misc import dict_flatten

#: human-readable budget for a cell name before the hash suffix kicks in
_NAME_BUDGET = 300


def cell_name(cell: dict) -> str:
    flat = dict_flatten(cell)
    text = ' '.join(f'{k}={v}' for k, v in flat.items())
    if len(text) <= _NAME_BUDGET:
        return text
    digest = hashlib.sha256(text.encode()).hexdigest()[:8]
    suffix = f' #{digest}'
    return text[-(_NAME_BUDGET - len(suffix)):] + suffix


def _axis_options(row, position: int):
    if isinstance(row, list):
        if not row:
            raise ValueError(f'empty grid axis at position {position}')
        if not all(isinstance(o, dict) for o in row):
            raise ValueError('grid axis list entries must be dicts')
        return row
    if isinstance(row, dict):
        if len(row) != 1:
            raise ValueError(
                'grid axis dict must contain exactly one key')
        key, value = next(iter(row.items()))
        if isinstance(value, str):
            if key != '_folder':
                raise ValueError(
                    'string-valued grid axis must use the _folder key')
            return [yaml_load(file=f)
                    for f in sorted(glob(join(value, '*.yml')))]
        if isinstance(value, list):
            if key == '_file':
                return [yaml_load(file=f) for f in value]
            return [{key: v} for v in value]
        raise ValueError('grid axis dict value must be list or str')
    raise ValueError(f'unknown grid axis type: {type(row)}')


def grid_cells(grid: list):
    axes = [_axis_options(row, i) for i, row in enumerate(grid)]
    cells = []
    for combo in product(*axes):
        cell = {}
        for option in combo:
            cell.update(option)
        cells.append((cell, cell_name(cell)))
    return cells


__all__ = ['grid_cells', 'cell_name']

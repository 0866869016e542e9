"""Config utilities (port of ``mlcomp_tpu/utils/config.py``).

``merge_dicts_smart`` is the suffix-path deep merge that grid cells and
``--params`` overrides go through: a source key like ``lr`` or
``optimizer/lr`` is matched against the suffix of the flattened target
paths; a unique match overwrites in place, an ambiguous one raises, and
an unmatched key is attached under the deepest known anchor sharing its
prefix (``model/norm`` lands on ``executors/train/model/norm``).
"""

import os
from collections import defaultdict

from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.utils.misc import dict_flatten, dict_unflatten


class Config(dict):
    """Dict wrapper with helpers."""

    @property
    def data_folder(self):
        from mlcomp_tpu_torch import DATA_FOLDER
        return os.path.join(DATA_FOLDER, self['info']['project'])

    @staticmethod
    def from_yaml(config: str):
        return Config(yaml_load(config))


def merge_dicts_smart(target: dict, source: dict, sep: str = '/') -> dict:
    """Deep-merge ``source`` into ``target`` with suffix-path key matching."""
    flat = dict_flatten(target, sep=sep)
    # suffix -> [full target paths ending with that suffix]
    suffix_index = defaultdict(list)
    # partial interior path -> full prefix path (anchor for new keys)
    anchors = {}
    for full in flat:
        parts = full.split(sep)
        n = len(parts)
        for i in range(n - 1, -1, -1):
            suffix_index[sep.join(parts[i:])].append(full)
            if 0 < i < n - 1:
                anchors[sep.join(parts[i:-1])] = sep.join(parts[:i + 1])
    expanded = {}
    for k, v in source.items():
        if isinstance(v, dict) and v:
            for kk, vv in dict_flatten(v, sep=sep).items():
                expanded[f'{k}{sep}{kk}'] = vv
        else:
            expanded[k] = v
    for k, v in expanded.items():
        matches = suffix_index.get(k, [])
        if not matches:
            # new key: re-anchor under the deepest known interior path
            parts = k.split(sep)
            dest = k
            for i in range(len(parts) - 1, 0, -1):
                head = sep.join(parts[:i])
                if head in anchors:
                    dest = anchors[head] + sep + sep.join(parts[i:])
                    break
            matches = [dest]
        if len(matches) > 1:
            raise ValueError(
                f'ambiguous config override {k!r}: matches {matches}')
        flat[matches[0]] = v
    return dict_unflatten(flat, sep=sep)


def dict_from_list_str(params) -> dict:
    """Parse CLI ``--params a/b:c`` pairs: int, then float, then
    ``True``/``False``, else the text."""
    out = {}
    for p in params:
        k, _, v = p.partition(':')
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                if v in ('True', 'False'):
                    out[k] = v == 'True'
                else:
                    out[k] = v
    return out


__all__ = ['Config', 'merge_dicts_smart', 'dict_from_list_str']

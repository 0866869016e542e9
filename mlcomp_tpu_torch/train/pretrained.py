"""Pretrained-weight loading with head-swap semantics — port of
``mlcomp_tpu/train/pretrained.py``.

A config says ``model: {name: ..., params_file: path}`` and the file is
one of

- an export of either package (``.msgpack``, read with the port's
  ``train/export.py`` ``load_export``; only the weights are read), or
- an ``.npz`` whose keys are ``/``-joined parameter paths
  (``params/dense_0/kernel``; a missing ``params/`` prefix means the
  whole archive is the params tree).

The merge runs in the JAX tree layout, so its rule and its summary are
the JAX package's, path for path: the live model's state becomes a JAX
tree (``convert.variables_to_jax``), a leaf loads iff the same path
exists there with the same shape (cast to the init leaf's dtype);
mismatched shapes keep their fresh init (a classifier head whose
``num_classes`` differs re-initializes), paths absent from the file
too, and loading nothing is an error: the file does not belong to this
architecture. ``convert.state_dict_from_jax`` then loads the merged tree
into the model, ``batch_stats`` into its running buffers.
"""

import os
from typing import Any, Dict, Tuple

import numpy as np

from mlcomp_tpu_torch.convert import (
    jax_family, state_dict_from_jax, to_tensor, variables_to_jax,
)


def load_pretrained_variables(path: str) -> Dict[str, Any]:
    """Read ``{'params': ..., 'batch_stats': ...?}`` from a local
    .msgpack export or .npz; ``path`` may omit the .msgpack suffix."""
    if path.endswith('.npz'):
        if not os.path.exists(path):
            raise FileNotFoundError(f'params_file not found: {path}')
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        tree: Dict[str, Any] = {}
        for key, value in flat.items():
            parts = [p for p in key.split('/') if p]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f'npz key {key!r} nests under a non-dict leaf')
            node[parts[-1]] = value
        if 'params' not in tree:
            tree = {'params': tree}
        return tree
    base = path[:-len('.msgpack')] if path.endswith('.msgpack') else path
    if not os.path.exists(base + '.msgpack'):
        raise FileNotFoundError(f'params_file not found: {base}.msgpack')
    from mlcomp_tpu_torch.train.export import load_export
    variables, _ = load_export(base)
    return variables


class MergeSummary:
    def __init__(self):
        self.loaded = []      # paths copied from the file
        self.reinit = []      # (path, file_shape, init_shape) mismatches
        self.missing = []     # init paths absent from the file

    def __str__(self):
        s = (f'{len(self.loaded)} leaves loaded, '
             f'{len(self.reinit)} shape-mismatched (fresh init), '
             f'{len(self.missing)} absent from file (fresh init)')
        if self.reinit:
            heads = ', '.join(
                '/'.join(p) + f' {fs}->{ins}'
                for p, fs, ins in self.reinit[:4])
            s += f'; reinitialized: {heads}'
        return s


def _merge_tree(init_tree, loaded_tree, path, summary: MergeSummary):
    if isinstance(init_tree, dict):
        # keys in sorted order, as JAX's tree functions rebuild a dict
        # (the JAX trainer's init tree), so the summary lists match
        loaded = loaded_tree if isinstance(loaded_tree, dict) else {}
        return {k: _merge_tree(v, loaded.get(k), path + (k,), summary)
                for k, v in sorted(init_tree.items())}
    if loaded_tree is None or isinstance(loaded_tree, dict):
        summary.missing.append(path)
        return init_tree
    init = to_tensor(init_tree)
    value = to_tensor(loaded_tree)
    if tuple(value.shape) != tuple(init.shape):
        summary.reinit.append((path, tuple(value.shape), tuple(init.shape)))
        return init_tree
    summary.loaded.append(path)
    return value.to(init.dtype)


def merge_pretrained(init_variables: Dict[str, Any],
                     loaded_variables: Dict[str, Any],
                     ) -> Tuple[Dict[str, Any], MergeSummary]:
    """Return ``init_variables`` (a JAX-layout tree) with every
    shape-matching leaf replaced by the loaded value, cast to the init
    leaf's dtype. Collections beyond params/batch_stats pass through."""
    summary = MergeSummary()
    out = {}
    for col, init_tree in init_variables.items():
        if col in ('params', 'batch_stats'):
            out[col] = _merge_tree(init_tree,
                                   loaded_variables.get(col), (col,),
                                   summary)
        else:
            out[col] = init_tree
    if not summary.loaded:
        raise ValueError(
            'params_file matched ZERO parameters of the freshly '
            'initialized model — the file does not belong to this '
            f'architecture ({len(summary.missing)} paths missing, '
            f'{len(summary.reinit)} shape mismatches)')
    return out, summary


def apply_pretrained(state, params_file: str):
    """Merge a local weight file into a fresh train state's model
    (parameters and running statistics), in place. Returns ``(state,
    summary)``. The optimizer state is left at init: fine-tuning starts
    with fresh moments, as in the JAX package."""
    loaded = load_pretrained_variables(params_file)
    model = state.model
    merged, summary = merge_pretrained(variables_to_jax(model), loaded)
    model.load_state_dict(state_dict_from_jax(merged, jax_family(model)))
    return state, summary


__all__ = ['load_pretrained_variables', 'merge_pretrained',
           'apply_pretrained', 'MergeSummary']

"""Stacked ↔ per-layer parameter-tree conversion (port of
``mlcomp_tpu/train/layer_stack.py``).

``scan_layers`` changes a JAX decoder stack's layout: the loop's
``layer_0 … layer_{L-1}`` sibling subtrees become ONE ``layers`` subtree
whose leaves carry a leading ``[L]`` axis. The transform is structural,
not model-specific. Leaves are numpy arrays or CPU torch tensors (the
msgpack reader gives bf16 leaves as torch tensors, numpy having no
bfloat16).
"""

import re
from typing import Any, Optional

import numpy as np
import torch

_LAYER_RE = re.compile(r'^layer_(\d+)$')
STACKED_KEY = 'layers'


def _layer_run(node: dict) -> Optional[list]:
    """['layer_0', ..., 'layer_{k-1}'] when node holds a dense run of
    per-layer dict subtrees, else None."""
    found = {}
    for key, value in node.items():
        m = _LAYER_RE.match(str(key))
        if m and isinstance(value, dict):
            found[int(m.group(1))] = key
    if not found or sorted(found) != list(range(len(found))):
        return None
    return [found[i] for i in range(len(found))]


def _tree_paths(tree: Any, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _tree_paths(value, prefix + (str(key),))
    else:
        yield prefix, tree


def _stack(parts):
    if torch.is_tensor(parts[0]):
        return torch.stack(parts)
    return np.stack([np.asarray(p) for p in parts])


def _leading_dim(leaf):
    shape = tuple(leaf.shape) if hasattr(leaf, 'shape') \
        else np.shape(leaf)
    return shape[0] if shape else None


def stack_layer_tree(tree: Any) -> Any:
    """Per-layer → stacked: every dense ``layer_0..layer_{k-1}`` run of
    identically-structured dict siblings becomes one ``layers`` subtree
    with each leaf stacked on a new leading axis."""
    if not isinstance(tree, dict):
        return tree
    out = {key: stack_layer_tree(value) for key, value in tree.items()}
    run = _layer_run(out)
    if run is None:
        return out
    layers = [out.pop(key) for key in run]
    shapes = [sorted(path for path, _ in _tree_paths(l)) for l in layers]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            'per-layer subtrees differ in structure — a heterogeneous '
            '(e.g. MoE-interleaved) stack cannot be scanned/stacked')

    def merge(parts):
        if isinstance(parts[0], dict):
            return {k: merge([p[k] for p in parts]) for k in parts[0]}
        return _stack(parts)

    if STACKED_KEY in out:
        raise ValueError(
            f'node already has a {STACKED_KEY!r} subtree next to '
            f'per-layer keys — refusing an ambiguous merge')
    out[STACKED_KEY] = merge(layers)
    return out


def unstack_layer_tree(tree: Any) -> Any:
    """Stacked → per-layer: every ``layers`` dict subtree whose leaves
    share a leading dim L expands back into ``layer_0..layer_{L-1}``."""
    if not isinstance(tree, dict):
        return tree
    out = {key: unstack_layer_tree(value) for key, value in tree.items()}
    stacked = out.get(STACKED_KEY)
    if not isinstance(stacked, dict):
        return out
    dims = {_leading_dim(leaf) for _, leaf in _tree_paths(stacked)}
    dims.discard(None)
    if len(dims) != 1:
        return out      # not a uniform stack — leave untouched
    n_layers = dims.pop()

    def split(node, i):
        if isinstance(node, dict):
            return {k: split(v, i) for k, v in node.items()}
        return node[i]

    out.pop(STACKED_KEY)
    for i in range(n_layers):
        out[f'layer_{i}'] = split(stacked, i)
    return out


__all__ = ['stack_layer_tree', 'unstack_layer_tree', 'STACKED_KEY']

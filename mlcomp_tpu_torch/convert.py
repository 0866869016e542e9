"""Carry transformer_lm weights between JAX parameter trees and the
port's ``state_dict``.

A JAX tree (what ``model.init`` returns under ``'params'``, or what an
export holds) stores each projection as a flax ``DenseGeneral`` kernel,
``[in..., out...]``; the port stores ``[out, in]`` weights:

=========================  =====================  =======================
JAX leaf                   JAX shape              port key, shape
=========================  =====================  =======================
embed                      [V, M]                 embed, same
pos_embed                  [S, M]                 pos_embed, same
<l>/norm_attn/scale        [M]                    layers.i.norm_attn.scale
<l>/attn/qkv/kernel        [M, 3, H, D]           layers.i.attn.qkv.weight [3HD, M]
<l>/attn/out/kernel        [H, D, M]              layers.i.attn.out.weight [M, HD]
<l>/norm_mlp/scale         [M]                    layers.i.norm_mlp.scale
<l>/mlp/wi_gate/kernel     [M, F]                 layers.i.mlp.wi_gate.weight [F, M]
<l>/mlp/wi_up/kernel       [M, F]                 layers.i.mlp.wi_up.weight [F, M]
<l>/mlp/wo/kernel          [F, M]                 layers.i.mlp.wo.weight [M, F]
norm_final/scale           [M]                    norm_final.scale
lm_head/kernel             [M, V]                 lm_head.weight [V, M]
=========================  =====================  =======================

``<l>`` is ``layer_i`` in the per-layer layout, or ``layers`` with a
leading ``[L]`` axis on every leaf in the stacked (``scan_layers``)
layout. Leaves are numpy arrays or CPU torch tensors; numpy arrays of
ml_dtypes' bfloat16 (what ``np.asarray`` of a JAX bf16 array gives)
become ``torch.bfloat16`` tensors, bit for bit.
"""

import numpy as np
import torch

from mlcomp_tpu_torch.train.layer_stack import (
    STACKED_KEY, stack_layer_tree, unstack_layer_tree,
)

_LAYER_LEAVES = (('norm_attn', 'scale'), ('attn', 'qkv', 'kernel'),
                 ('attn', 'out', 'kernel'), ('norm_mlp', 'scale'),
                 ('mlp', 'wi_gate', 'kernel'), ('mlp', 'wi_up', 'kernel'),
                 ('mlp', 'wo', 'kernel'))


def to_tensor(x) -> torch.Tensor:
    """A CPU tensor with x's values and dtype (bf16 included)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    x = np.asarray(x)
    if not (x.flags.writeable and x.flags.c_contiguous):
        x = np.array(x, order='C')      # torch wants writable memory
    if x.dtype.name == 'bfloat16':
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _to_leaf(t: torch.Tensor):
    """Port tensor → JAX-tree leaf: numpy, except bf16 (stays torch)."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _get(tree, path, where):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f'JAX params missing {"/".join(path)} in {where}')
        node = node[key]
    return node


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


def params_from_jax(tree) -> dict:
    """JAX transformer_lm params (stacked or per-layer) → the port's
    ``state_dict`` of CPU tensors. Raises on a leaf it does not know
    (e.g. MoE or int8-quantised layers, which the port does not
    implement)."""
    if STACKED_KEY in tree:
        tree = unstack_layer_tree(tree)
    layers = sorted((k for k in tree if k.startswith('layer_')),
                    key=lambda k: int(k.split('_')[1]))
    expected = 4 + len(layers) * len(_LAYER_LEAVES)
    if _leaf_count(tree) != expected:
        raise ValueError(
            f'JAX params hold {_leaf_count(tree)} leaves, a dense '
            f'{len(layers)}-layer transformer_lm has {expected} — '
            f'MoE or int8 layers are not ported')
    sd = {'embed': to_tensor(tree['embed']),
          'pos_embed': to_tensor(tree['pos_embed'])}
    for i, name in enumerate(layers):
        layer = tree[name]
        pre = f'layers.{i}.'
        qkv = to_tensor(_get(layer, ('attn', 'qkv', 'kernel'), name))
        out = to_tensor(_get(layer, ('attn', 'out', 'kernel'), name))
        m = qkv.shape[0]
        sd[pre + 'norm_attn.scale'] = to_tensor(
            _get(layer, ('norm_attn', 'scale'), name))
        sd[pre + 'attn.qkv.weight'] = qkv.reshape(m, -1).T.contiguous()
        sd[pre + 'attn.out.weight'] = \
            out.reshape(-1, out.shape[-1]).T.contiguous()
        sd[pre + 'norm_mlp.scale'] = to_tensor(
            _get(layer, ('norm_mlp', 'scale'), name))
        for proj in ('wi_gate', 'wi_up', 'wo'):
            sd[pre + f'mlp.{proj}.weight'] = to_tensor(
                _get(layer, ('mlp', proj, 'kernel'), name)).T.contiguous()
    sd['norm_final.scale'] = to_tensor(
        _get(tree, ('norm_final', 'scale'), 'params'))
    sd['lm_head.weight'] = to_tensor(
        _get(tree, ('lm_head', 'kernel'), 'params')).T.contiguous()
    return sd


def params_to_jax(state_dict, n_heads: int, stacked: bool = True) -> dict:
    """The port's ``state_dict`` → a JAX transformer_lm params tree, in
    the stacked (``stacked=True``) or per-layer layout."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    n_layers = 1 + max((int(k.split('.')[1]) for k in sd
                        if k.startswith('layers.')), default=-1)
    tree = {'embed': _to_leaf(sd['embed']),
            'pos_embed': _to_leaf(sd['pos_embed'])}
    for i in range(n_layers):
        pre = f'layers.{i}.'
        qkv = sd[pre + 'attn.qkv.weight']          # [3HD, M]
        out = sd[pre + 'attn.out.weight']          # [M, HD]
        m = qkv.shape[1]
        d = qkv.shape[0] // (3 * n_heads)
        tree[f'layer_{i}'] = {
            'norm_attn': {'scale': _to_leaf(sd[pre + 'norm_attn.scale'])},
            'attn': {
                'qkv': {'kernel': _to_leaf(
                    qkv.T.reshape(m, 3, n_heads, d))},
                'out': {'kernel': _to_leaf(
                    out.T.reshape(n_heads, d, out.shape[0]))}},
            'norm_mlp': {'scale': _to_leaf(sd[pre + 'norm_mlp.scale'])},
            'mlp': {proj: {'kernel': _to_leaf(
                sd[pre + f'mlp.{proj}.weight'].T)}
                for proj in ('wi_gate', 'wi_up', 'wo')}}
    tree['norm_final'] = {'scale': _to_leaf(sd['norm_final.scale'])}
    tree['lm_head'] = {'kernel': _to_leaf(sd['lm_head.weight'].T)}
    return stack_layer_tree(tree) if stacked else tree


__all__ = ['params_from_jax', 'params_to_jax', 'to_tensor']

"""Carry weights between JAX variable trees and the port's
``state_dict``: ``transformer_lm`` below, the image models (``mlp``,
the ResNets, with their ``batch_stats``) under "image models" further
down; ``state_dict_from_jax`` and ``variables_to_jax`` dispatch on the
model.

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
    ``state_dict`` of CPU tensors (an int8-trained model's too: its
    ``Int8DenseGeneral`` keeps ``DenseGeneral``'s ``kernel``). Raises on
    a tree of another structure (e.g. MoE layers, which the port does
    not implement)."""
    if STACKED_KEY in tree:
        tree = unstack_layer_tree(tree)
    layers = sorted((k for k in tree if k.startswith('layer_')),
                    key=lambda k: int(k.split('_')[1]))
    expected = 4 + len(layers) * len(_LAYER_LEAVES)
    if _leaf_count(tree) != expected:
        raise ValueError(
            f'JAX params hold {_leaf_count(tree)} leaves, a dense '
            f'{len(layers)}-layer transformer_lm has {expected} — '
            f'MoE layers are not ported')
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


def port_module_name(path) -> str:
    """The port's module name of a JAX module path (a tuple of names):
    a per-layer LM's ``layer_i`` is the port's ``layers.i``; every other
    path joins with dots, as ``image_state_dict_from_jax`` keys it."""
    head, rest = path[0], tuple(path[1:])
    if head.startswith('layer_'):
        return '.'.join(('layers', head[len('layer_'):]) + rest)
    return '.'.join(path)


def lm_kernel_shapes(state_dict, n_heads: int) -> dict:
    """{parameter name: the shape of its JAX ``kernel``} for each
    projection of a transformer_lm ``state_dict``: the JAX kernel is
    ``weight.t().reshape(shape)`` (``qkv`` [M, 3, H, D], ``out``
    [H, D, M], the MLP's and the head [in, out])."""
    shapes = {}
    for name, w in state_dict.items():
        if not name.endswith('.weight'):
            continue
        d_out, d_in = w.shape
        if name.endswith('attn.qkv.weight'):
            shapes[name] = (d_in, 3, n_heads, d_out // (3 * n_heads))
        elif name.endswith('attn.out.weight'):
            shapes[name] = (n_heads, d_in // n_heads, d_out)
        else:
            shapes[name] = (d_in, d_out)
    return shapes


def jax_kernel_shapes(model) -> dict:
    """``lm_kernel_shapes`` of a port transformer_lm; {} for the image
    models, whose kernels keep their own two largest dims. Adafactor
    factors its second moments over these shapes, as optax does over
    the JAX tree."""
    cfg = getattr(model, 'cfg', None)
    if cfg is None:
        return {}
    return lm_kernel_shapes(model.state_dict(), cfg.n_heads)


def params_to_jax(state_dict, n_heads: int, stacked: bool = True) -> dict:
    """The port's ``state_dict`` → a JAX transformer_lm params tree, in
    the stacked (``stacked=True``) or per-layer layout."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    shapes = lm_kernel_shapes(sd, n_heads)

    def kernel(name):
        return _to_leaf(sd[name].T.reshape(shapes[name]))

    n_layers = 1 + max((int(k.split('.')[1]) for k in sd
                        if k.startswith('layers.')), default=-1)
    tree = {'embed': _to_leaf(sd['embed']),
            'pos_embed': _to_leaf(sd['pos_embed'])}
    for i in range(n_layers):
        pre = f'layers.{i}.'
        tree[f'layer_{i}'] = {
            'norm_attn': {'scale': _to_leaf(sd[pre + 'norm_attn.scale'])},
            'attn': {proj: {'kernel': kernel(f'{pre}attn.{proj}.weight')}
                     for proj in ('qkv', 'out')},
            'norm_mlp': {'scale': _to_leaf(sd[pre + 'norm_mlp.scale'])},
            'mlp': {proj: {'kernel': kernel(f'{pre}mlp.{proj}.weight')}
                    for proj in ('wi_gate', 'wi_up', 'wo')}}
    tree['norm_final'] = {'scale': _to_leaf(sd['norm_final.scale'])}
    tree['lm_head'] = {'kernel': kernel('lm_head.weight')}
    return stack_layer_tree(tree) if stacked else tree


# ------------------------------------------------------------ image models
#: leaf names that are ``batch_stats`` in a JAX tree and buffers in the
#: port (the running statistics of the ResNets' norms)
STAT_LEAVES = ('mean', 'var')


def _flatten(tree, prefix=''):
    for key, value in tree.items():
        path = f'{prefix}{key}'
        if isinstance(value, dict):
            yield from _flatten(value, path + '.')
        else:
            yield path, value


def _image_leaf_from_jax(path: str, leaf) -> tuple:
    t = to_tensor(leaf)
    head, _, name = path.rpartition('.')
    if name != 'kernel':
        return path, t
    if t.dim() == 4:                 # conv HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    elif t.dim() == 2:               # dense [in, out] -> [out, in]
        t = t.T
    else:
        raise ValueError(f'{path}: a kernel of shape {tuple(t.shape)} is '
                         f'neither a conv nor a dense kernel')
    return f'{head}.weight', t.contiguous()


def image_state_dict_from_jax(variables: dict) -> dict:
    """JAX ``{'params': ..., 'batch_stats': ...}`` of an ``mlp`` or a
    ResNet → the port's ``state_dict`` (parameters and the running
    statistics' buffers), keyed by the JAX paths joined with dots: conv
    kernels HWIO → ``weight`` OIHW, dense kernels [in, out] → ``weight``
    [out, in], every other leaf (biases, norm scales, WSConv gains,
    ``mean``/``var``) as it is."""
    sd = dict(_image_leaf_from_jax(p, v)
              for p, v in _flatten(variables['params']))
    for path, value in _flatten(variables.get('batch_stats') or {}):
        sd[path] = to_tensor(value)
    return sd


def image_variables_to_jax(state_dict) -> dict:
    """The port's ``state_dict`` of an ``mlp`` or a ResNet → the JAX
    ``{'params': ...}`` tree, with ``'batch_stats'`` when it holds
    running statistics."""
    variables = {'params': {}}
    for key, value in state_dict.items():
        head, _, name = key.rpartition('.')
        t = value.detach().cpu()
        kind = 'params'
        if name in STAT_LEAVES:
            kind = 'batch_stats'
        elif name == 'weight':
            name = 'kernel'
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        node = variables.setdefault(kind, {})
        for part in head.split('.') if head else ():
            node = node.setdefault(part, {})
        node[name] = _to_leaf(t)
    return variables


def unwrap_value_nodes(tree):
    """Collapse flax Partitioned state-dict nodes ({'value': leaf}) left
    by serializing logically-partitioned params (a JAX checkpoint's
    ``params`` hold them)."""
    if isinstance(tree, dict):
        if set(tree.keys()) == {'value'}:
            return unwrap_value_nodes(tree['value'])
        return {k: unwrap_value_nodes(v) for k, v in tree.items()}
    return tree


def state_dict_from_jax(variables: dict, name: str) -> dict:
    """A JAX export's or checkpoint's variables → the ``state_dict`` of
    the port's model ``name``."""
    variables = unwrap_value_nodes(variables)
    if name.lower() == 'transformer_lm':
        return params_from_jax(variables['params'])
    return image_state_dict_from_jax(variables)


def variables_to_jax(model) -> dict:
    """The JAX variables (``params`` and, where the model keeps running
    statistics, ``batch_stats``) of a port model: a host copy, which the
    next train step's in-place updates leave alone."""
    sd = {k: v.detach().to('cpu', copy=True)
          for k, v in model.state_dict().items()}
    cfg = getattr(model, 'cfg', None)
    if cfg is not None:                         # transformer_lm
        stacked = cfg.scan_layers if cfg.scan_layers != 'auto' else True
        return {'params': params_to_jax(sd, n_heads=cfg.n_heads,
                                        stacked=bool(stacked))}
    return image_variables_to_jax(sd)


def input_shape_from_params(name: str, params: dict):
    """The input shape an image model's weights imply, for building the
    port's model around an export without one: a ResNet's stem gives its
    channels, an MLP's first layer its features; None for others."""
    if name.lower().startswith('resnet'):
        return (None, None, int(to_tensor(params['conv_stem']['kernel'])
                               .shape[2]))
    if name.lower() == 'mlp':
        return (int(to_tensor(params['dense_0']['kernel']).shape[0]),)
    return None


__all__ = ['params_from_jax', 'params_to_jax', 'port_module_name',
           'to_tensor',
           'image_state_dict_from_jax', 'image_variables_to_jax',
           'jax_kernel_shapes', 'lm_kernel_shapes',
           'state_dict_from_jax', 'variables_to_jax',
           'input_shape_from_params', 'STAT_LEAVES']

"""Model export + batched inference on the card (port of
``mlcomp_tpu/train/export.py``, including ``export_from_checkpoint``).

The export format is the JAX package's, so either package reads what the
other writes: ``<name>.msgpack`` holds the unboxed ``{'params', ...}``
variables in flax's msgpack layout (``utils/msgpack_io.py`` reads and
writes it without flax or msgpack), and ``<name>.json`` holds
``{'model': spec, ...meta}``. The port rebuilds the model from the spec
with its own registry and moves the JAX weights (and an image model's
``batch_stats``) across with ``convert.state_dict_from_jax``.

``make_predictor`` is the engine under the serving process: the model is
built and loaded once, batches are applied in fixed-size chunks with the
tail padded by repeats and sliced off after, and an optional
softmax/sigmoid/argmax head runs on the device.

``quantize='int8'`` is the counterpart of ``_quantized_interceptor``:
the port has no method interceptor, so the chosen ``Dense`` modules of
the built model are swapped for ``ops.int8_matmul.Int8Dense``, quantized
once on the device (the f32 weight is not kept). Which ones follows the
JAX parameter tree, not the torch shapes: a ``kernel`` leaf that is 2-D
with at least 65,536 elements (``quantized_modules``). So a stacked
(``layers``) LM export quantizes its ``lm_head`` alone (its MLP kernels
are 3-D), a per-layer one each layer's ``wi_gate``, ``wi_up`` and ``wo``
too; attention's ``qkv`` and ``out`` kernels are 4-D and 3-D there and
never quantize, and the CIFAR ResNet-18's 512×10 head is too small.
An int8-trained export (``matmul_precision: int8`` in its spec) builds
its projections as ``Int8DenseGeneral``, whose forward is the dynamic
int8 training product, as JAX's predictor runs it; the interceptor
reroutes ``nn.Dense`` modules only, so ``quantize='int8'`` swaps its
``lm_head`` alone, whatever the layout.
"""

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch.convert import unwrap_value_nodes
from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.utils.msgpack_io import msgpack_chunks, msgpack_restore


def export_base(path: str) -> str:
    """Strip an optional .msgpack suffix — the canonical export stem."""
    return path[:-len('.msgpack')] if path.endswith('.msgpack') else path


def export_model(out_path: str, params, model_spec: dict,
                 batch_stats=None, meta: dict = None) -> str:
    """Write ``<out_path>.msgpack`` + ``<out_path>.json``; returns the
    msgpack path. ``params`` is a JAX-layout tree of numpy arrays or CPU
    tensors (a port model's weights: ``convert.params_to_jax``)."""
    variables = {'params': unwrap_value_nodes(params)}
    if batch_stats is not None:
        variables['batch_stats'] = unwrap_value_nodes(batch_stats)
    base = export_base(os.fspath(out_path))
    os.makedirs(os.path.dirname(base) or '.', exist_ok=True)
    blob_path = base + '.msgpack'
    tmp = blob_path + '.tmp'
    with open(tmp, 'wb') as fh:
        fh.writelines(msgpack_chunks(variables))
    os.replace(tmp, blob_path)
    with open(base + '.json', 'w') as fh:
        json.dump({'model': dict(model_spec), **(meta or {})}, fh)
    return blob_path


def export_from_checkpoint(ck_path: str, model_spec: dict, out_path: str,
                           meta: dict = None) -> str:
    """Export from a train-state checkpoint blob (``last``/``best
    .msgpack``, either package's) without knowing the optimizer that
    saved it: the untyped tree is read and its JAX-layout ``params`` (and
    ``batch_stats``, if any) lifted out."""
    if os.path.isdir(ck_path):
        raise NotImplementedError(
            f'{ck_path} is a sharded checkpoint directory: the sharded '
            f'format is not ported yet (ROADMAP.md, queue A: A4)')
    with open(ck_path, 'rb') as fh:
        raw = msgpack_restore(fh.read())
    stats = raw.get('batch_stats')
    return export_model(out_path, unwrap_value_nodes(raw['params']),
                        model_spec, meta=meta,
                        batch_stats=None if stats is None
                        else unwrap_value_nodes(stats))


def load_export_meta(path: str) -> dict:
    """The export's full .json sidecar ({'model': spec, ...meta}), or
    {} when absent."""
    base = export_base(os.fspath(path))
    if os.path.exists(base + '.json'):
        with open(base + '.json') as fh:
            return json.load(fh)
    return {}


def load_export(path: str) -> Tuple[dict, dict]:
    """Returns (variables, model_spec) from an export written by either
    package's ``export_model``. ``path`` may omit the .msgpack suffix."""
    base = export_base(os.fspath(path))
    with open(base + '.msgpack', 'rb') as fh:
        variables = msgpack_restore(fh.read())
    spec = load_export_meta(base).get('model', {})
    return unwrap_value_nodes(variables), spec


def build_model(variables: dict, model_spec: dict, device='cuda'):
    """The spec's model on ``device`` in eval mode, holding the export's
    weights and running statistics (``batch_stats``)."""
    from mlcomp_tpu_torch.convert import (
        input_shape_from_params, state_dict_from_jax,
    )
    from mlcomp_tpu_torch.models import create_model
    if not model_spec or 'name' not in model_spec:
        raise ValueError('model spec missing (no .json next to export?)')
    dev = resolve_device(device)
    name = model_spec['name']
    model = create_model(**model_spec, device=dev,
                         input_shape=input_shape_from_params(
                             name, variables['params']))
    model.load_state_dict(state_dict_from_jax(variables, name))
    return model.eval()


_ACTIVATIONS = ('softmax', 'sigmoid', 'argmax', None)

#: a JAX ``kernel`` quantizes when it is 2-D with at least this many
#: elements (``_quantized_interceptor``'s ``min_size``)
QUANTIZE_MIN_SIZE = 65536


def quantized_modules(params: dict) -> list:
    """Names of the port modules whose JAX ``kernel`` leaf the JAX
    package's ``_quantized_interceptor`` quantizes: 2-D, at least
    QUANTIZE_MIN_SIZE elements."""
    from mlcomp_tpu_torch.convert import port_module_name
    names = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (key,))
        elif len(path) > 1 and path[-1] == 'kernel':
            shape = tuple(getattr(tree, 'shape', ()))
            if len(shape) == 2 and shape[0] * shape[1] >= QUANTIZE_MIN_SIZE:
                names.append(port_module_name(path[:-1]))

    walk(params, ())
    return names


def quantize_model(model, names) -> int:
    """Swap each named ``Dense`` of ``model`` for an ``Int8Dense``
    quantized from its weight where it lies; a module that is not a
    ``Dense`` of the port stays as it is (the interceptor, too, passes
    every other module through). Returns the number swapped."""
    from mlcomp_tpu_torch.models.resnet import Dense as ImageDense
    from mlcomp_tpu_torch.models.transformer import Dense as LmDense
    from mlcomp_tpu_torch.ops.int8_matmul import Int8Dense
    swapped = 0
    for name in names:
        parent_name, _, attr = name.rpartition('.')
        parent = model.get_submodule(parent_name)
        module = getattr(parent, attr)
        if isinstance(module, (LmDense, ImageDense)):
            setattr(parent, attr, Int8Dense.from_dense(module))
            swapped += 1
    return swapped


def make_predictor(file: str = None, model_spec: dict = None,
                   variables: dict = None, batch_size: int = 512,
                   activation: Optional[str] = None,
                   quantize: Optional[str] = None, device='cuda'):
    """Build a reusable ``predict(x) -> np.ndarray`` over a model export,
    on ``device`` (the card unless the caller asks for the CPU).

    The model is loaded once; ``predict`` applies it in chunks of
    ``batch_size`` rows, the tail padded with repeats and sliced off
    after. Outputs are f32, except ``argmax``, which takes the index on
    the model's own logits (the argmax of bf16 logits is the argmax of
    their f32 cast) and returns int32 as the JAX package does.

    ``quantize='int8'`` swaps the large 2-D ``Dense`` projections for
    weight-only int8 ones (module docstring); ``predict.quantized`` is
    the number swapped (0 keeps the model as it is, as JAX keeps its
    plain apply).
    """
    if activation not in _ACTIVATIONS:
        raise ValueError(f'activation must be one of {_ACTIVATIONS}')
    if quantize not in (None, 'int8'):
        raise ValueError(f"quantize must be None or 'int8', "
                         f'got {quantize!r}')
    if variables is None:
        if file is None:
            raise ValueError('need file= or variables=')
        variables, file_spec = load_export(file)
        model_spec = model_spec or file_spec
    model = build_model(variables, model_spec, device)
    dev = next(model.parameters()).device
    quantized = 0
    if quantize == 'int8':
        quantized = quantize_model(model,
                                   quantized_modules(variables['params']))

    @torch.inference_mode()
    def apply(batch: np.ndarray) -> np.ndarray:
        out = model(torch.from_numpy(np.ascontiguousarray(batch)).to(dev))
        if activation == 'argmax':
            out = out.argmax(dim=-1).to(torch.int32)
        else:
            out = out.float()
            if activation == 'softmax':
                out = torch.softmax(out, dim=-1)
            elif activation == 'sigmoid':
                out = torch.sigmoid(out)
        return out.cpu().numpy()

    def predict(x: np.ndarray) -> np.ndarray:
        n = len(x)
        bs = min(batch_size, max(n, 1))
        outs = []
        for start in range(0, n, bs):
            batch = x[start:start + bs]
            n_real = len(batch)
            if n_real < bs:
                take = np.resize(np.arange(n_real), bs)
                batch = batch[take]
            outs.append(apply(batch)[:n_real])
        return np.concatenate(outs) if outs else np.empty((0,))

    predict.model = model
    predict.quantized = quantized
    return predict


__all__ = ['export_model', 'export_from_checkpoint', 'export_base',
           'load_export', 'load_export_meta', 'build_model', 'make_predictor',
           'quantized_modules', 'quantize_model', 'QUANTIZE_MIN_SIZE']

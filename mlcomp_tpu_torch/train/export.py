"""Model export + batched inference on the card (port of
``mlcomp_tpu/train/export.py``).

The export format is the JAX package's, so either package reads what the
other writes: ``<name>.msgpack`` holds the unboxed ``{'params', ...}``
variables in flax's msgpack layout (``utils/msgpack_io.py`` reads and
writes it without flax or msgpack), and ``<name>.json`` holds
``{'model': spec, ...meta}``. The port rebuilds the model from the spec
with its own registry and moves the JAX weights across with
``convert.params_from_jax``.

``make_predictor`` is the engine under the serving process: the model is
built and loaded once, batches are applied in fixed-size chunks with the
tail padded by repeats and sliced off after, and an optional
softmax/sigmoid/argmax head runs on the device.
"""

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mlcomp_tpu_torch.utils.device import resolve_device
from mlcomp_tpu_torch.utils.msgpack_io import msgpack_chunks, msgpack_restore


def _unwrap_value_nodes(tree):
    """Collapse flax Partitioned state-dict nodes ({'value': leaf}) left
    by serializing logically-partitioned params."""
    if isinstance(tree, dict):
        if set(tree.keys()) == {'value'}:
            return _unwrap_value_nodes(tree['value'])
        return {k: _unwrap_value_nodes(v) for k, v in tree.items()}
    return tree


def export_base(path: str) -> str:
    """Strip an optional .msgpack suffix — the canonical export stem."""
    return path[:-len('.msgpack')] if path.endswith('.msgpack') else path


def export_model(out_path: str, params, model_spec: dict,
                 batch_stats=None, meta: dict = None) -> str:
    """Write ``<out_path>.msgpack`` + ``<out_path>.json``; returns the
    msgpack path. ``params`` is a JAX-layout tree of numpy arrays or CPU
    tensors (a port model's weights: ``convert.params_to_jax``)."""
    variables = {'params': _unwrap_value_nodes(params)}
    if batch_stats is not None:
        variables['batch_stats'] = _unwrap_value_nodes(batch_stats)
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
    return _unwrap_value_nodes(variables), spec


def build_model(variables: dict, model_spec: dict, device='cuda'):
    """The spec's model on ``device`` in eval mode, holding the export's
    weights."""
    from mlcomp_tpu_torch.convert import params_from_jax
    from mlcomp_tpu_torch.models import create_model
    if not model_spec or 'name' not in model_spec:
        raise ValueError('model spec missing (no .json next to export?)')
    dev = resolve_device(device)
    model = create_model(**model_spec, device=dev)
    model.load_state_dict(params_from_jax(variables['params']))
    return model.eval()


_ACTIVATIONS = ('softmax', 'sigmoid', 'argmax', None)


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
    """
    if activation not in _ACTIVATIONS:
        raise ValueError(f'activation must be one of {_ACTIVATIONS}')
    if quantize not in (None, 'int8'):
        raise ValueError(f"quantize must be None or 'int8', "
                         f'got {quantize!r}')
    if quantize == 'int8':
        raise NotImplementedError(
            "quantize='int8' serving is not ported yet (ROADMAP.md, queue "
            'A: the int8 serving path with the int8 matmul kernel)')
    if variables is None:
        if file is None:
            raise ValueError('need file= or variables=')
        variables, file_spec = load_export(file)
        model_spec = model_spec or file_spec
    model = build_model(variables, model_spec, device)
    dev = next(model.parameters()).device

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
    return predict


__all__ = ['export_model', 'export_base', 'load_export', 'load_export_meta',
           'build_model', 'make_predictor']

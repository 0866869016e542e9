"""Model registry (counterpart of ``mlcomp_tpu/models/base.py``).

The registry holds ``nn.Module`` factories keyed by the same names the
JAX package uses, so an export's ``{'name': ..., **kwargs}`` spec builds
the port's model unchanged. It holds all 111 of the JAX registry's
names but ``pipelined_lm`` (ROADMAP.md A4): the LMs, ``vit``, ``mlp``,
the ResNets, the encoder classifiers, the segmentation decoders and
``unet`` (``models/__init__.py`` lists them).
"""

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(factory):
        _REGISTRY[name.lower()] = factory
        return factory
    return deco


def create_model(name: str, **kwargs):
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(
            f'model {name!r} is not ported to mlcomp_tpu_torch yet; '
            f'ported: {sorted(_REGISTRY)}')
    return _REGISTRY[key](**kwargs)


def model_names():
    return sorted(_REGISTRY)


def param_count(params) -> int:
    """Element count of an ``nn.Module``'s parameters or of a
    ``state_dict``."""
    tensors = params.parameters() if hasattr(params, 'parameters') \
        else params.values()
    return int(sum(t.numel() for t in tensors))


__all__ = ['register_model', 'create_model', 'model_names', 'param_count']

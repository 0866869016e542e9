"""Small helpers (counterpart of ``mlcomp_tpu/utils/misc.py``)."""

import re


def to_snake(name: str) -> str:
    """``JaxTrain`` → ``jax_train``: the executor registry's key rule."""
    s1 = re.sub('(.)([A-Z][a-z]+)', r'\1_\2', name)
    return re.sub('([a-z0-9])([A-Z])', r'\1_\2', s1).lower()


__all__ = ['to_snake']

"""Small helpers (port of the parts of ``mlcomp_tpu/utils/misc.py`` the
port's control plane uses)."""

import datetime
import os
import random
import re
import socket

import numpy as np


def now():
    """Naive UTC now — all DB timestamps use this."""
    return datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)


def hostname() -> str:
    """This computer's name in the control plane; ``MLCOMP_HOSTNAME``
    overrides the OS hostname."""
    return os.environ.get('MLCOMP_HOSTNAME') or socket.gethostname()


def set_global_seed(seed: int):
    """Seed python's, numpy's and torch's generators (every device's)."""
    import torch
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def to_snake(name: str) -> str:
    """``JaxTrain`` → ``jax_train``: the executor registry's key rule."""
    s1 = re.sub('(.)([A-Z][a-z]+)', r'\1_\2', name)
    return re.sub('([a-z0-9])([A-Z])', r'\1_\2', s1).lower()


def duration_format(seconds) -> str:
    """``3725`` → ``1h 2m 5s``: the DAG graph's node labels."""
    if seconds is None:
        return ''
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f'{h}h {m}m {s}s'
    if m:
        return f'{m}m {s}s'
    return f'{s}s'


def dict_flatten(d: dict, sep: str = '/', prefix: str = '') -> dict:
    out = {}
    for k, v in d.items():
        key = f'{prefix}{sep}{k}' if prefix else str(k)
        if isinstance(v, dict) and v:
            out.update(dict_flatten(v, sep=sep, prefix=key))
        else:
            out[key] = v
    return out


def dict_unflatten(d: dict, sep: str = '/') -> dict:
    out = {}
    for k, v in d.items():
        parts = k.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


__all__ = ['now', 'hostname', 'set_global_seed', 'to_snake',
           'duration_format', 'dict_flatten', 'dict_unflatten']

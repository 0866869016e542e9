"""mlcomp_tpu_torch — the PyTorch/CUDA port of mlcomp_tpu, for NVIDIA
Hopper (H100).

The JAX package ``mlcomp_tpu`` stays the reference; this package grows
beside it slice by slice and imports nothing from it. Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is
a kernel written by hand for ``sm_90a`` under ``csrc/``.

Only the environment the serving slice needs is carried over from
``mlcomp_tpu/__init__.py``: the same root-folder rule (``MLCOMP_TPU_ROOT``,
the per-xdist-worker test sandbox, ``~/mlcomp_tpu`` by default), the
same ``models/`` folder and the same ``TOKEN`` read from the same
``configs/.env``, so both packages find the same exports and accept the
same token. Unlike the JAX package, importing this one creates, writes
and wipes nothing.
"""

import os

__version__ = '0.1.0'


def _sandbox_root():
    """Same rule as ``mlcomp_tpu._sandbox_root``."""
    worker = os.getenv('PYTEST_XDIST_WORKER')
    explicit = os.getenv('MLCOMP_TPU_ROOT')
    if explicit:
        return explicit
    base = os.path.expanduser('~/mlcomp_tpu')
    if worker is not None or os.getenv('MLCOMP_TPU_TEST') is not None:
        return os.path.join(
            os.path.expanduser('~/mlcomp_tpu_tests'), worker or 'main')
    return base


ROOT_FOLDER = _sandbox_root()
MODEL_FOLDER = os.path.join(ROOT_FOLDER, 'models')
CONFIG_FOLDER = os.path.join(ROOT_FOLDER, 'configs')


def _read_env(path):
    """KEY=VALUE lines of ``configs/.env``; for a key the file names, a
    value already in the environment wins (the JAX package's rule). A
    missing file reads as the JAX package's default, which names
    ``TOKEN=token``."""
    lines = ['TOKEN=token']
    if os.path.exists(path):
        with open(path) as fh:
            lines = fh.read().splitlines()
    out = {}
    for line in lines:
        line = line.strip()
        if not line or line.startswith('#') or '=' not in line:
            continue
        k, _, v = line.partition('=')
        k, v = k.strip(), v.strip()
        out[k] = os.environ.get(k, v)
    return out


_ENV = _read_env(os.path.join(CONFIG_FOLDER, '.env'))
TOKEN = _ENV.get('TOKEN', 'token')

__all__ = ['__version__', 'ROOT_FOLDER', 'MODEL_FOLDER', 'CONFIG_FOLDER',
           'TOKEN']

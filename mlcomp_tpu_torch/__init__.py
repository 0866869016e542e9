"""mlcomp_tpu_torch — the PyTorch/CUDA port of mlcomp_tpu, for NVIDIA
Hopper (H100).

The JAX package ``mlcomp_tpu`` stays the reference; this package grows
beside it slice by slice and imports nothing from it. Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is
a kernel written by hand for ``sm_90a`` under ``csrc/``.

The environment is ``mlcomp_tpu/__init__.py``'s: the same root-folder
rule (``MLCOMP_TPU_ROOT``, the per-xdist-worker test sandbox,
``~/mlcomp_tpu`` by default), the same folders under it, the keys this
package reads from the same ``configs/.env`` with the same defaults
(``TOKEN``, ``INSTALL_LIBRARIES``, ``DB_TYPE``; for the supervisor and
the worker daemon ``QUEUE_POLL_INTERVAL``, ``MASTER_PORT_RANGE``,
``WORKER_USAGE_INTERVAL``, ``SYNC_WITH_THIS_COMPUTER``,
``CAN_PROCESS_TASKS``, ``DOCKER_IMG``, ``IP`` and ``PORT``; for the site
``WEB_HOST`` and ``WEB_PORT``), and the
same DB connection string (``sqlite:///<root>/db/sqlite.db``). Both packages
therefore find the same exports, accept the same token and open the
same DB file. Unlike the JAX package, importing this one creates,
writes and wipes nothing: ``python -m mlcomp_tpu_torch init`` and the
first ``Session.create_session()`` make the folders
(``ensure_folders``).
"""

import os

__version__ = '0.1.0'

#: the JAX package's default ``configs/.env`` (``mlcomp_tpu/__init__.py``
#: ``_DEFAULT_ENV``), written by ``ensure_folders`` where none exists
DEFAULT_ENV = """\
# mlcomp_tpu machine-level configuration.
# Every variable here is exported into the process environment on import.
ROOT_FOLDER=
TOKEN=token
WORKER_TOKEN=
INSTALL_LIBRARIES=False
DB_TYPE=SQLITE
POSTGRES_DB=mlcomp_tpu
POSTGRES_USER=mlcomp_tpu
POSTGRES_PASSWORD=
POSTGRES_HOST=localhost
PGDATA=/var/lib/postgresql/data
QUEUE_POLL_INTERVAL=0.2
WEB_HOST=0.0.0.0
WEB_PORT=4201
WEB_REFRESH_INTERVAL=5000
CONSOLE_LOG_LEVEL=DEBUG
DB_LOG_LEVEL=INFO
FILE_LOG_LEVEL=INFO
LOG_NAME=log
IP=localhost
PORT=4202
MASTER_PORT_RANGE=29500-29510
NCCL_SOCKET_IFNAME=
FILE_SYNC_INTERVAL=300
WORKER_USAGE_INTERVAL=10
SYNC_WITH_THIS_COMPUTER=True
CAN_PROCESS_TASKS=True
TPU_CORES_PER_HOST=
DOCKER_IMG=default
DOCKER_MAIN=True
"""


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
DATA_FOLDER = os.path.join(ROOT_FOLDER, 'data')
MODEL_FOLDER = os.path.join(ROOT_FOLDER, 'models')
TASK_FOLDER = os.path.join(ROOT_FOLDER, 'tasks')
LOG_FOLDER = os.path.join(ROOT_FOLDER, 'logs')
CONFIG_FOLDER = os.path.join(ROOT_FOLDER, 'configs')
DB_FOLDER = os.path.join(ROOT_FOLDER, 'db')
TMP_FOLDER = os.path.join(ROOT_FOLDER, 'tmp')
FOLDERS = (DATA_FOLDER, MODEL_FOLDER, TASK_FOLDER, LOG_FOLDER,
           CONFIG_FOLDER, DB_FOLDER, TMP_FOLDER)
ENV_FILE = os.path.join(CONFIG_FOLDER, '.env')


def ensure_folders():
    """Create the root's folders and, where none exists, the default
    ``configs/.env`` — what importing the JAX package does."""
    for folder in FOLDERS:
        os.makedirs(folder, exist_ok=True)
    if not os.path.exists(ENV_FILE):
        with open(ENV_FILE, 'w') as fh:
            fh.write(DEFAULT_ENV)


def _read_env(path):
    """KEY=VALUE lines of ``configs/.env``; for a key the file names, a
    value already in the environment wins (the JAX package's rule). A
    missing file reads as the default one."""
    text = DEFAULT_ENV
    if os.path.exists(path):
        with open(path) as fh:
            text = fh.read()
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#') or '=' not in line:
            continue
        k, _, v = line.partition('=')
        k, v = k.strip(), v.strip()
        out[k] = os.environ.get(k, v)
    return out


_ENV = _read_env(ENV_FILE)

TOKEN = _ENV.get('TOKEN', 'token')
INSTALL_LIBRARIES = os.environ.get(
    'INSTALL_LIBRARIES',
    _ENV.get('INSTALL_LIBRARIES', 'False')).lower() in ('1', 'true', 'yes')
DB_TYPE = _ENV.get('DB_TYPE', 'SQLITE')
if DB_TYPE == 'SQLITE':
    SA_CONNECTION_STRING = 'sqlite:///' + os.path.join(DB_FOLDER, 'sqlite.db')
elif DB_TYPE == 'SERVER':
    # the JAX package's string; db/core.py refuses it (ROADMAP.md, A0)
    SA_CONNECTION_STRING = _ENV.get(
        'SERVER_URL', f"http://{_ENV.get('IP', 'localhost')}:"
                      f"{_ENV.get('WEB_PORT', '4201')}")
else:
    SA_CONNECTION_STRING = (
        f"postgresql://{_ENV.get('POSTGRES_USER')}:"
        f"{_ENV.get('POSTGRES_PASSWORD')}@{_ENV.get('POSTGRES_HOST')}:5432/"
        f"{_ENV.get('POSTGRES_DB')}")

MASTER_PORT_RANGE = tuple(
    int(p) for p in _ENV.get('MASTER_PORT_RANGE', '29500-29510').split('-'))
QUEUE_POLL_INTERVAL = float(_ENV.get('QUEUE_POLL_INTERVAL', '0.2'))
WORKER_USAGE_INTERVAL = float(_ENV.get('WORKER_USAGE_INTERVAL', '10'))
SYNC_WITH_THIS_COMPUTER = _ENV.get(
    'SYNC_WITH_THIS_COMPUTER', 'True') == 'True'
CAN_PROCESS_TASKS = _ENV.get('CAN_PROCESS_TASKS', 'True') == 'True'
DOCKER_IMG = _ENV.get('DOCKER_IMG', 'default')
# the JAX package exports configs/.env into os.environ on import and its
# register_computer reads IP and PORT from there; this package exports
# nothing, so the daemon reads the same values from here
IP = _ENV.get('IP', 'localhost')
PORT = int(_ENV.get('PORT', '4202'))
# where ``server start-site`` serves the API and the dashboard
WEB_HOST = _ENV.get('WEB_HOST', '0.0.0.0')
WEB_PORT = int(_ENV.get('WEB_PORT', '4201'))

__all__ = [
    '__version__', 'ROOT_FOLDER', 'DATA_FOLDER', 'MODEL_FOLDER',
    'TASK_FOLDER', 'LOG_FOLDER', 'CONFIG_FOLDER', 'DB_FOLDER', 'TMP_FOLDER',
    'TOKEN', 'INSTALL_LIBRARIES', 'DB_TYPE', 'SA_CONNECTION_STRING',
    'MASTER_PORT_RANGE', 'QUEUE_POLL_INTERVAL', 'WORKER_USAGE_INTERVAL',
    'SYNC_WITH_THIS_COMPUTER', 'CAN_PROCESS_TASKS', 'DOCKER_IMG', 'IP',
    'PORT', 'WEB_HOST', 'WEB_PORT', 'ensure_folders',
]

"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<key>.so \\
         csrc/<name>.cu

at first use, into ``build/torch_kernels/`` beside the package (or
``$MLCOMP_TPU_TORCH_BUILD``). ``<key>`` hashes the source, the headers
under ``csrc/`` and the flags, so an edited kernel rebuilds and an
unchanged one loads from disk. ``build()`` starts one ``nvcc`` for each
source that is missing, all together, and waits for them. Nothing here
runs at import: the CPU tests import every module, and this machine
class may have no ``nvcc`` at all.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_ENV = 'MLCOMP_TPU_TORCH_BUILD'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBS = {}
#: name -> {'path', 'seconds', 'log'} of the builds this process ran
#: (``log`` holds ptxas's register / shared-memory / spill report)
BUILD_LOGS = {}


def build_dir() -> str:
    return os.environ.get(BUILD_ENV) or os.path.join(
        os.path.dirname(PACKAGE_DIR), 'build', 'torch_kernels')


def kernel_names() -> list:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        'nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin '
        '— the CUDA kernels build only where the CUDA toolkit is installed')


def source_key(name: str) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, name + '.cu')] + sorted(
            glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as fh:
            h.update(os.path.basename(path).encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f'{name}-{source_key(name)}.so')


def build(names=None) -> dict:
    """Compile every named kernel (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` each, in parallel. Returns
    ``{name: library path}``; raises with nvcc's output on failure."""
    names = kernel_names() if names is None else list(names)
    missing = [n for n in names if not os.path.exists(library_path(n))]
    compiler = nvcc() if missing else None
    if missing:
        os.makedirs(build_dir(), exist_ok=True)
    running = {}
    for name in missing:
        out = library_path(name)
        # a private temp name, then an atomic rename: two processes
        # building at once both end with a whole library
        tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
        cmd = [compiler, *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, name + '.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = {'path': out, 'log': log,
                            'seconds': time.monotonic() - t0}
        if proc.returncode != 0:
            failed.append(f'--- {name} (nvcc exit {proc.returncode})\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(path)
        return lib


__all__ = ['build', 'library', 'kernel_names', 'library_path', 'nvcc',
           'BUILD_LOGS']

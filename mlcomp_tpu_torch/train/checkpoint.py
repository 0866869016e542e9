"""Checkpoint save/restore with stage/epoch resume arithmetic — port of
``mlcomp_tpu/train/checkpoint.py`` (the single-host msgpack format; the
sharded per-host format is not ported yet, ROADMAP.md queue A: A4).

Layout, as in the JAX package: ``<dir>/last.msgpack`` and
``<dir>/best.msgpack``, each with ``.meta.json`` carrying {step, stage,
stage_epoch, epoch, score, time}. A blob is a flax-format msgpack map
written with ``utils/msgpack_io.py``. The port's train state stores
``params`` and, for a model with running statistics, ``batch_stats`` in
the JAX layout (``convert.variables_to_jax``), so either package's
``export_from_checkpoint`` reads it; ``opt_state`` is in the port's own
layout (ROADMAP: resuming across packages needs an
optimizer-state converter).

Writes are durable: tmp file, flush, fsync, atomic rename, then the
directory fsync'd. A torn ``last`` (unreadable, or not restorable into
the caller's state) falls back to ``best`` with a warning.
"""

import json
import logging
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Optional, Tuple

from mlcomp_tpu_torch.testing.faults import fault_point
from mlcomp_tpu_torch.utils.msgpack_io import msgpack_chunks, msgpack_restore

logger = logging.getLogger(__name__)


def _meta_path(path: str) -> str:
    return path + '.meta.json'


def _write_durable(path: str, chunks, mode: str = 'wb'):
    """Write + flush + fsync (the rename after it is then atomic against
    power loss as well as against a crash of this process)."""
    with open(path, mode) as fh:
        fh.writelines(chunks)
        fh.flush()
        os.fsync(fh.fileno())


def _copy_durable(src: str, dst: str):
    """tmp + fsync + os.replace copy: ``best`` is the torn-``last``
    fallback target, so it is committed at least as durably."""
    tmp = dst + '.tmp'
    with open(src, 'rb') as s, open(tmp, 'wb') as d:
        shutil.copyfileobj(s, d)
        d.flush()
        os.fsync(d.fileno())
    os.replace(tmp, dst)


def _fsync_dir(directory: str):
    """Persist the renames themselves. Best-effort: not every
    filesystem exposes a directory fd."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(directory: str, state: dict, meta: dict,
                    best: bool = False) -> str:
    """Serialise ``state`` (a nested dict of host arrays, CPU tensors and
    ints) to ``last.msgpack`` (and ``best.msgpack`` when ``best``).
    Returns the last-checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    meta = dict(meta, time=time.time())
    last = os.path.join(directory, 'last.msgpack')
    tmp = last + '.tmp'
    _write_durable(tmp, msgpack_chunks(state))
    os.replace(tmp, last)
    # chaos: crash between the two commits — blob new, meta old
    fault_point('checkpoint.between_writes', path=last)
    meta_tmp = _meta_path(last) + '.tmp'
    _write_durable(meta_tmp, [json.dumps(meta)], mode='w')
    os.replace(meta_tmp, _meta_path(last))
    _fsync_dir(directory)
    if best:
        best_path = os.path.join(directory, 'best.msgpack')
        _copy_durable(last, best_path)
        _copy_durable(_meta_path(last), _meta_path(best_path))
        _fsync_dir(directory)
    return last


class AsyncCheckpointWriter:
    """Serialise + write checkpoints on a background thread so the
    training loop never stalls on disk. The caller hands over a host copy
    of the state (the port updates parameters in place, so the copy has
    to be taken before the next step).

    Saves run FIFO on one worker thread, so last/best ordering holds.
    ``wait()`` drains the queue (call it before anything reads the
    files); a failed save re-raises there and on the next ``submit``."""

    def __init__(self):
        # bounded: at most one queued + one in-flight host copy
        self._q = queue.Queue(maxsize=1)
        self._err = None
        self._thread = threading.Thread(
            target=self._run, name='ckpt-writer', daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception as e:  # surfaced on wait()/next submit()
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, directory: str, state, meta: dict,
               best: bool = False):
        self._raise_pending()
        self._q.put((save_checkpoint, (directory, state, meta),
                     {'best': best}))

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=60)


def _load_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except (json.JSONDecodeError, OSError):
        return None


def checkpoint_exists(directory: str,
                      kind: str = 'last') -> Optional[str]:
    """Path of the ``kind`` checkpoint blob, else None."""
    path = os.path.join(directory, f'{kind}.msgpack')
    return path if os.path.exists(path) else None


def load_meta(directory: str, kind: str = 'last') -> Optional[dict]:
    """Just the meta sidecar (a truncated or corrupt one reads as
    absent, so the caller starts fresh instead of wedging)."""
    return _load_json(
        _meta_path(os.path.join(directory, f'{kind}.msgpack')))


def restore_checkpoint(directory: str,
                       target: Optional[Callable[[dict], Any]] = None,
                       kind: str = 'last'
                       ) -> Tuple[Optional[Any], Optional[dict]]:
    """Restore the ``kind`` checkpoint: the raw tree, or ``target(tree)``
    (which loads it into the caller's state and raises when it does not
    fit). Returns (state, meta), or (None, None) when absent. An
    unreadable or unfitting ``last`` falls back to ``best``."""
    path = checkpoint_exists(directory, kind)
    if path is None:
        return None, None
    try:
        with open(path, 'rb') as fh:
            tree = msgpack_restore(fh.read())
        state = target(tree) if target is not None else tree
    except Exception as e:
        if kind == 'last' and checkpoint_exists(directory, 'best'):
            logger.warning(
                'checkpoint %s is unreadable (%s); falling back to the '
                'best checkpoint', path, e)
            return restore_checkpoint(directory, target, kind='best')
        raise
    return state, _load_json(_meta_path(path)) or {}


def resume_plan(stages: list, meta: Optional[dict]) -> Tuple[list, int]:
    """Given config stages [{name, epochs, ...}] and a restored meta,
    return (remaining_stages, epochs_done_in_first_remaining_stage):
    completed stages are dropped; the stage the checkpoint was taken in
    resumes with its epoch counter advanced."""
    if not meta:
        return list(stages), 0
    ck_stage = meta.get('stage')
    ck_epoch = int(meta.get('stage_epoch', 0))
    names = [s['name'] for s in stages]
    if ck_stage not in names:
        return list(stages), 0
    idx = names.index(ck_stage)
    stage_epochs = int(stages[idx].get('epochs', 1))
    if ck_epoch + 1 >= stage_epochs:
        # stage finished → resume at the next stage from scratch
        return list(stages[idx + 1:]), 0
    return list(stages[idx:]), ck_epoch + 1


__all__ = ['checkpoint_exists', 'save_checkpoint', 'restore_checkpoint',
           'resume_plan', 'load_meta', 'AsyncCheckpointWriter']

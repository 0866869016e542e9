"""Failure taxonomy (port of ``classify_exception`` from
``mlcomp_tpu/recovery.py``): the verdict the task pipeline's failure
path writes into ``task.failure_reason``. The retry policy that reads it
belongs to the supervisor (ROADMAP.md, A0's second half).

==============  =========  ==================================================
reason          class      raised by
==============  =========  ==================================================
db-error        transient  sqlite errors
io-error        transient  ``ConnectionError``/``TimeoutError``/``OSError``
oom             permanent  out of device memory (CUDA's ``OutOfMemoryError``
                           says "out of memory") or host ``MemoryError``
executor-error  permanent  any other exception, and the deterministic OS
                           errors (missing file, permission, ...)
==============  =========  ==================================================
"""

import sqlite3

#: deterministic OSError subclasses that must NOT classify as transient
_DETERMINISTIC_OS_ERRORS = (FileNotFoundError, PermissionError,
                            IsADirectoryError, NotADirectoryError)

#: error-text markers of device memory exhaustion (XLA's status name,
#: the allocators' wordings; CUDA's ``OutOfMemoryError`` says "out of
#: memory")
_OOM_MARKERS = ('resource_exhausted', 'resource exhausted',
                'out of memory', 'out-of-memory',
                'memory allocation failure')


def classify_exception(exc) -> str:
    """Failure reason for an exception raised by the task pipeline.
    Walks the cause/context chain so a transient root wrapped in a
    framework exception still classifies transient. (The JAX package's
    gang carve-out, ``gang=True``, waits for distributed tasks: A4.)"""
    seen = set()
    cur = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, MemoryError):
            return 'oom'        # host-side exhaustion: same verdict
        if isinstance(cur, RuntimeError):
            text = f'{type(cur).__name__}: {cur}'.lower()
            if any(marker in text for marker in _OOM_MARKERS):
                return 'oom'
        if isinstance(cur, sqlite3.Error):
            return 'db-error'
        if isinstance(cur, _DETERMINISTIC_OS_ERRORS):
            return 'executor-error'
        if isinstance(cur, (ConnectionError, TimeoutError, OSError)):
            return 'io-error'
        cur = cur.__cause__ or cur.__context__
    return 'executor-error'


__all__ = ['classify_exception']

"""Logging: console + rotating file + database handler (port of
``mlcomp_tpu/utils/logging.py``).

``create_logger`` fans out to three handlers; the DB handler writes
`Log` rows carrying (component, computer, task, step, module:function,
line); messages are truncated to 16,000 chars.

Trace correlation: every record is stamped with the process's active
cross-process trace context (``TraceContextFilter`` →
``[trace=<id> role=<role>]`` in the console/file format), so the logs
of one dispatch grep out by the same trace id that joins its spans.
"""

import logging
import os
import threading
import traceback
from logging.handlers import RotatingFileHandler

from mlcomp_tpu_torch.db.enums import ComponentType, LogStatus

MESSAGE_LIMIT = 16_000

_LEVEL_TO_STATUS = {
    logging.DEBUG: LogStatus.Debug,
    logging.INFO: LogStatus.Info,
    logging.WARNING: LogStatus.Warning,
    logging.ERROR: LogStatus.Error,
    logging.CRITICAL: LogStatus.Error,
}


class TraceContextFilter(logging.Filter):
    """Stamp the active cross-process trace context
    (telemetry/spans.py) onto every record as ``record.trace``, so the
    console/file formatter prints ``[trace=<id> role=<role>]`` on each
    worker/train line — grepping one trace id finds the logs of that
    dispatch alongside its spans. Traceless processes (API, CLI) pay a
    dict read and print nothing extra."""

    def filter(self, record):
        if not hasattr(record, 'trace'):
            try:
                from mlcomp_tpu_torch.telemetry.spans import get_trace_context
                trace_id, role = get_trace_context()
            except Exception:
                trace_id = role = None
            record.trace = (
                f' [trace={trace_id} role={role or "?"}]'
                if trace_id else '')
        return True


class DbHandler(logging.Handler):
    def __init__(self, session):
        super().__init__()
        self.session = session

    def emit(self, record):
        try:
            from mlcomp_tpu_torch.db.models import Log
            from mlcomp_tpu_torch.utils.misc import now
            component, computer, task, step = _extract_meta(record)
            try:
                component = int(component)
            except (TypeError, ValueError):
                component = int(ComponentType.API)
            msg = str(record.getMessage())[:MESSAGE_LIMIT]
            if record.exc_info:
                msg += '\n' + ''.join(
                    traceback.format_exception(*record.exc_info)
                )[:MESSAGE_LIMIT]
            self.session.add(Log(
                message=msg,
                time=now(),
                level=int(_LEVEL_TO_STATUS.get(record.levelno,
                                               LogStatus.Info)),
                component=component,
                module=f'{record.module}:{record.funcName}',
                line=record.lineno,
                task=task,
                step=step,
                computer=computer,
            ))
        except Exception:
            # logging must never take the process down
            pass


def _extract_meta(record):
    """Positional log args are (component, computer, task, step) — parity
    with the reference's convention (utils/logging.py:76-103)."""
    component = getattr(record, 'component', ComponentType.API)
    from mlcomp_tpu_torch.utils.misc import hostname
    computer = getattr(record, 'computer', hostname())
    task = getattr(record, 'task', None)
    step = getattr(record, 'step', None)
    return component, computer, task, step


class _Logger(logging.Logger):
    """Logger whose level methods accept trailing positional metadata:
    ``logger.info(msg, component, computer, task, step)``."""

    def _meta_call(self, base, msg, *args, exc_info=None):
        extra = {}
        keys = ('component', 'computer', 'task', 'step')
        for key, val in zip(keys, args):
            if val is not None:
                extra[key] = val
        # stacklevel=3: skip _meta_call + the public wrapper, so the
        # record points at the real call site
        base(msg, extra=extra, exc_info=exc_info, stacklevel=3)

    def debug(self, msg, *args, **kw):
        if args:
            return self._meta_call(super().debug, msg, *args, **kw)
        kw.setdefault('stacklevel', 2)
        return super().debug(msg, **kw)

    def info(self, msg, *args, **kw):
        if args:
            return self._meta_call(super().info, msg, *args, **kw)
        kw.setdefault('stacklevel', 2)
        return super().info(msg, **kw)

    def warning(self, msg, *args, **kw):
        if args:
            return self._meta_call(super().warning, msg, *args, **kw)
        kw.setdefault('stacklevel', 2)
        return super().warning(msg, **kw)

    def error(self, msg, *args, **kw):
        if args:
            return self._meta_call(super().error, msg, *args, **kw)
        kw.setdefault('stacklevel', 2)
        return super().error(msg, **kw)


_loggers = {}
_loggers_lock = threading.Lock()


def create_logger(session=None, name: str = 'mlcomp_tpu_torch'):
    """Console + rotating file + DB logger (reference utils/logging.py:60-105).

    ``_Logger`` instances are constructed directly and cached here — NOT
    registered via ``logging.setLoggerClass`` — so third-party loggers keep
    stdlib %-formatting semantics. Passing ``session`` on a later call
    attaches the DB handler to an already-created logger.
    """
    from mlcomp_tpu_torch import LOG_FOLDER
    with _loggers_lock:
        logger = _loggers.get(name)
        if logger is None:
            logger = _Logger(name)
            logger.setLevel(logging.DEBUG)
            # %(trace)s is stamped by TraceContextFilter — empty
            # outside a traced dispatch, ' [trace=.. role=..]' inside
            logger.addFilter(TraceContextFilter())
            fmt = logging.Formatter(
                '%(asctime)s [%(levelname)s] '
                '%(module)s:%(funcName)s:%(lineno)d%(trace)s '
                '%(message)s')

            console = logging.StreamHandler()
            console.setLevel(os.getenv('CONSOLE_LOG_LEVEL', 'DEBUG'))
            console.setFormatter(fmt)
            logger.addHandler(console)

            os.makedirs(LOG_FOLDER, exist_ok=True)
            file_handler = RotatingFileHandler(
                os.path.join(LOG_FOLDER,
                             os.getenv('LOG_NAME', 'log') + '.log'),
                maxBytes=10 * 2 ** 20, backupCount=5)
            file_handler.setLevel(os.getenv('FILE_LOG_LEVEL', 'INFO'))
            file_handler.setFormatter(fmt)
            logger.addHandler(file_handler)
            _loggers[name] = logger

        if session is not None:
            existing = [h for h in logger.handlers
                        if isinstance(h, DbHandler)]
            if existing:
                # session heal: the old connection may be closed — rebind
                # every cached DbHandler to the fresh session
                for h in existing:
                    h.session = session
            else:
                db_handler = DbHandler(session)
                db_handler.setLevel(os.getenv('DB_LOG_LEVEL', 'INFO'))
                logger.addHandler(db_handler)

    return logger


__all__ = ['create_logger', 'DbHandler', 'TraceContextFilter',
           'MESSAGE_LIMIT']

"""DB core: keyed singleton sessions over stdlib sqlite3 (port of
``mlcomp_tpu/db/core.py``, its sqlite driver).

- ``Session.create_session(key=...)`` returns a process-wide singleton per
  key; the first one makes the root's folders (``ensure_folders``)
- WAL journal + busy timeout so several processes on one host share the
  metadata store, and a bounded retry with counters on SQLITE_BUSY
- a small declarative layer (``Column`` + ``DBModel``) the schema modules
  use; the migration runner generates the DDL from it, so the schema is
  the JAX package's own
- automatic adaptation of numpy scalars, datetimes, bools and enums

Only ``sqlite:///`` is ported: a ``postgresql://`` or server
(``http://``) connection string raises, naming the later A0 item of
ROADMAP.md; it never carries on against sqlite.
"""

import datetime
import json
import os
import sqlite3
import threading
import time

import numpy as np

from mlcomp_tpu_torch.testing.faults import fault_point

_SQLITE_PREFIX = 'sqlite:///'

#: bounded retry on sqlite 'database is locked' (SQLITE_BUSY). The
#: 30 s busy_timeout below handles most contention, but WAL writers
#: can still surface an immediate lock error (e.g. a read transaction
#: upgrading to write against a concurrent writer). Before this, one
#: locked commit during a worker-side metric flush surfaced as a task
#: failure; now it costs at most ~1.5 s of backoff before giving up.
_BUSY_RETRIES = 5
_BUSY_BASE_SLEEP_S = 0.05

#: process-wide busy-retry counters. A contended control plane used to
#: degrade SILENTLY (each retry just slept); these feed the
#: ``db.busy_retries`` metric series (sampled per supervisor tick) and
#: the ``mlcomp_db_busy_retries_total`` /metrics family, so lock
#: pressure is visible before it becomes give-ups.
_BUSY_STATS_LOCK = threading.Lock()
_BUSY_STATS = {'retries': 0, 'gave_up': 0}


def busy_retry_stats() -> dict:
    """Snapshot of this process's SQLITE_BUSY retry counters."""
    with _BUSY_STATS_LOCK:
        return dict(_BUSY_STATS)


def _record_busy(kind: str):
    with _BUSY_STATS_LOCK:
        _BUSY_STATS[kind] += 1


def _is_busy_error(e) -> bool:
    return isinstance(e, sqlite3.OperationalError) and (
        'locked' in str(e).lower() or 'busy' in str(e).lower())


def adapt_value(v):
    """Convert python/numpy values to sqlite-storable primitives."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return json.dumps(v.tolist())
    if isinstance(v, datetime.datetime):
        return v.strftime('%Y-%m-%d %H:%M:%S.%f')
    if isinstance(v, bool):
        return int(v)
    from mlcomp_tpu_torch.db.enums import OrderedEnum
    if isinstance(v, OrderedEnum):
        return int(v)
    return v


def parse_datetime(s):
    if s is None or isinstance(s, datetime.datetime):
        return s
    for fmt in ('%Y-%m-%d %H:%M:%S.%f', '%Y-%m-%d %H:%M:%S'):
        try:
            return datetime.datetime.strptime(s, fmt)
        except ValueError:
            continue
    return None


class Column:
    """Declarative column spec (the reference used sqlalchemy.Column)."""

    _counter = 0

    def __init__(self, type_='TEXT', primary_key=False, nullable=True,
                 default=None, foreign_key=None, index=False, unique=False,
                 dtype=None):
        self.type = type_
        self.primary_key = primary_key
        self.nullable = nullable
        self.default = default
        self.foreign_key = foreign_key  # 'table.column'
        self.index = index
        self.unique = unique
        self.dtype = dtype  # python-side type: 'datetime'|'bool'|None
        self.name = None
        Column._counter += 1
        self._order = Column._counter

    def ddl(self):
        parts = [f'"{self.name}"', self.type]
        if self.primary_key:
            parts.append('PRIMARY KEY AUTOINCREMENT'
                         if self.type == 'INTEGER' else 'PRIMARY KEY')
        if not self.nullable and not self.primary_key:
            parts.append('NOT NULL')
        if self.unique:
            parts.append('UNIQUE')
        if self.foreign_key:
            t, c = self.foreign_key.split('.')
            parts.append(f'REFERENCES {t}({c}) ON DELETE CASCADE')
        return ' '.join(parts)


class _ModelMeta(type):
    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        cols = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Column):
                    v.name = k
                    cols[k] = v
        cls.__columns__ = dict(
            sorted(cols.items(), key=lambda kv: kv[1]._order))
        return cls


class DBModel(metaclass=_ModelMeta):
    """Base for declarative models (reference db/models/base.py:1-4).

    Instances are plain attribute bags; ``to_dict`` serializes them the way
    the reference's sqlalchemy_serializer did (datetimes to isoformat).
    """

    __tablename__ = None

    def __init__(self, **kwargs):
        for k, col in self.__columns__.items():
            setattr(self, k, kwargs.pop(k, col.default))
        if kwargs:
            raise TypeError(
                f'{type(self).__name__}: unknown fields {sorted(kwargs)}')

    @classmethod
    def from_row(cls, row):
        obj = cls.__new__(cls)
        keys = row.keys()
        for k, col in cls.__columns__.items():
            v = row[k] if k in keys else col.default
            if v is not None:
                if col.dtype == 'datetime':
                    v = parse_datetime(v)
                elif col.dtype == 'bool':
                    v = bool(v)
            setattr(obj, k, v)
        return obj

    def to_dict(self):
        out = {}
        for k in self.__columns__:
            v = getattr(self, k, None)
            if isinstance(v, datetime.datetime):
                v = v.isoformat()
            elif isinstance(v, bool):
                v = int(v)
            out[k] = v
        return out

    @classmethod
    def create_table_ddl(cls):
        cols = ',\n  '.join(c.ddl() for c in cls.__columns__.values())
        ddl = [f'CREATE TABLE IF NOT EXISTS {cls.__tablename__} '
               f'(\n  {cols}\n)']
        for c in cls.__columns__.values():
            if c.index:
                ddl.append(
                    f'CREATE INDEX IF NOT EXISTS '
                    f'idx_{cls.__tablename__}_{c.name} '
                    f'ON {cls.__tablename__}("{c.name}")')
        return ddl

    def __repr__(self):
        pk = getattr(self, 'id', None)
        return f'<{type(self).__name__} id={pk}>'


def insert_sql(obj):
    """(sql, values) for inserting a DBModel instance."""
    cols, vals = [], []
    for k, col in obj.__columns__.items():
        v = getattr(obj, k, None)
        if col.primary_key and v is None:
            continue
        cols.append(f'"{k}"')
        vals.append(v)
    sql = (f'INSERT INTO {obj.__tablename__} '
           f'({", ".join(cols)}) VALUES ({", ".join("?" * len(cols))})')
    return sql, vals


def update_sql(obj, fields=None):
    """(sql, values) for updating a DBModel instance by primary key."""
    pk = next(k for k, c in obj.__columns__.items() if c.primary_key)
    fields = fields or [k for k in obj.__columns__ if k != pk]
    sets = ', '.join(f'"{f}"=?' for f in fields)
    vals = [getattr(obj, f, None) for f in fields]
    vals.append(getattr(obj, pk))
    return (f'UPDATE {obj.__tablename__} SET {sets} WHERE "{pk}"=?',
            vals)


class _Result:
    """Materialized statement result (rows consumed before commit)."""

    def __init__(self, rows, lastrowid, rowcount):
        self._rows = rows
        self.lastrowid = lastrowid
        self.rowcount = rowcount

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self):
        return self._rows


class Session:
    """Keyed singleton DB session: one sqlite3 connection guarded by an
    RLock. WAL mode allows concurrent reader/writer processes on one
    host."""

    __session_holder = {}
    _lock = threading.RLock()


    def __init__(self, connection_string, key):
        self.key = key
        self.connection_string = connection_string
        assert connection_string.startswith(_SQLITE_PREFIX), \
            'only sqlite:/// connection strings reach the sqlite driver'
        self.db_path = connection_string[len(_SQLITE_PREFIX):]
        db_dir = os.path.dirname(self.db_path)
        if db_dir:
            os.makedirs(db_dir, exist_ok=True)
        self._conn = sqlite3.connect(
            self.db_path, check_same_thread=False, timeout=30.0)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute('PRAGMA journal_mode=WAL')
        self._conn.execute('PRAGMA foreign_keys=ON')
        self._conn.execute('PRAGMA busy_timeout=30000')
        self._conn.execute('PRAGMA synchronous=NORMAL')
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ api
    @classmethod
    def create_session(cls, key='default', connection_string=None):
        with cls._lock:
            if key in cls.__session_holder:
                return cls.__session_holder[key]
            if connection_string is None:
                import mlcomp_tpu_torch
                connection_string = mlcomp_tpu_torch.SA_CONNECTION_STRING
                mlcomp_tpu_torch.ensure_folders()
            if not connection_string.startswith(_SQLITE_PREFIX):
                raise NotImplementedError(
                    f'DB {connection_string.split(":")[0]!r}: only sqlite '
                    f'is ported; PostgreSQL and the server-proxied DB are '
                    f'the second half of A0 (ROADMAP.md)')
            s = cls(connection_string, key)
            cls.__session_holder[key] = s
            return s

    @classmethod
    def cleanup(cls, key=None):
        """Drop cached sessions (reference recreates sessions on SA errors)."""
        with cls._lock:
            keys = [key] if key else list(cls.__session_holder)
            for k in keys:
                s = cls.__session_holder.pop(k, None)
                if s is not None:
                    try:
                        s.close()
                    except Exception:
                        pass

    def close(self):
        self._conn.close()

    def _retry_busy(self, op):
        """Run one statement op with bounded backoff on SQLITE_BUSY.
        The lock is NOT held across the sleeps (each attempt acquires
        it inside ``op``), so a blocked writer doesn't freeze the
        other threads sharing this session. Statements here are
        single-statement transactions, so a retry never replays a
        half-applied batch."""
        for attempt in range(_BUSY_RETRIES + 1):
            try:
                return op()
            except sqlite3.OperationalError as e:
                if not _is_busy_error(e):
                    raise
                if attempt >= _BUSY_RETRIES:
                    _record_busy('gave_up')
                    raise
                _record_busy('retries')
            time.sleep(_BUSY_BASE_SLEEP_S * (2 ** attempt))

    def execute(self, sql, params=()):
        params = tuple(adapt_value(p) for p in params)

        def op():
            with self._lock:
                try:
                    fault_point('db.execute', sql=sql)  # chaos: outage
                    cur = self._conn.execute(sql, params)
                    # consume RETURNING rows before commit
                    rows = cur.fetchall() if cur.description else []
                    result = _Result(rows, cur.lastrowid, cur.rowcount)
                    self._conn.commit()
                    return result
                except Exception:
                    self._conn.rollback()
                    raise

        return self._retry_busy(op)

    def executemany(self, sql, seq):
        seq = [tuple(adapt_value(p) for p in row) for row in seq]

        def op():
            with self._lock:
                try:
                    fault_point('db.execute', sql=sql)  # chaos: outage
                    cur = self._conn.executemany(sql, seq)
                    self._conn.commit()
                    return cur
                except Exception:
                    self._conn.rollback()
                    raise

        return self._retry_busy(op)

    def query(self, sql, params=()):
        params = tuple(adapt_value(p) for p in params)
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_one(self, sql, params=()):
        params = tuple(adapt_value(p) for p in params)
        with self._lock:
            return self._conn.execute(sql, params).fetchone()

    # --------------------------------------------------------------- schema
    def table_columns(self, table: str) -> set:
        """Column names of ``table`` (empty when absent), for the guarded
        ALTERs of the migration chain."""
        return {r['name'] for r in
                self.query(f'PRAGMA table_info({table})')}

    # -------------------------------------------------------------- events
    #: whether publish_event reaches OTHER processes: not on sqlite, so a
    #: cross-process waiter keeps its short-poll timeout
    events_cross_process = False

    def publish_event(self, channel: str):
        """Wake-on-work publication (db/events.py): only waiters in this
        process hear it (a condition variable)."""
        from mlcomp_tpu_torch.db import events
        events.publish(channel)

    def event_snapshot(self, channels) -> dict:
        """Channel-sequence snapshot to pass into ``wait_event``, taken
        BEFORE the caller's emptiness check so a publish landing in
        between is never slept through."""
        from mlcomp_tpu_torch.db import events
        return events.snapshot(channels)

    def wait_event(self, channels, timeout: float,
                   snapshot: dict = None) -> bool:
        """Block until a watched channel publishes or ``timeout`` passes;
        True when woken by an event."""
        from mlcomp_tpu_torch.db import events
        return events.wait(channels, timeout, snapshot=snapshot)

    # --------------------------------------------------------------- object
    def add(self, obj, commit=True):
        sql, raw_vals = insert_sql(obj)
        vals = [adapt_value(v) for v in raw_vals]
        # decided BEFORE the first attempt: a busy-retried INSERT must
        # overwrite the id a rolled-back attempt stamped on the object
        # (that row never committed — keeping its id would alias
        # whatever another writer inserts there in the meantime)
        assign_id = hasattr(obj, 'id') and \
            getattr(obj, 'id', None) is None

        def op():
            with self._lock:
                try:
                    cur = self._conn.execute(sql, vals)
                    if assign_id:
                        obj.id = cur.lastrowid
                    if commit:
                        self._conn.commit()
                    return obj
                except Exception:
                    self._conn.rollback()
                    raise

        # commit=False rides inside a caller-managed batch (add_all):
        # retrying one INSERT there would replay into a transaction the
        # rollback just discarded — only self-committing adds retry
        return self._retry_busy(op) if commit else op()

    def add_all(self, objs):
        for o in objs:
            self.add(o, commit=False)
        with self._lock:
            self._conn.commit()

    def update_obj(self, obj, fields=None):
        sql, vals = update_sql(obj, fields)
        self.execute(sql, vals)

    def commit(self):
        with self._lock:
            self._conn.commit()


__all__ = ['Session', 'Column', 'DBModel', 'adapt_value',
           'parse_datetime', 'insert_sql', 'update_sql',
           'busy_retry_stats']

"""Epoch fencing: a zombie ex-leader's writes are rejected in the DB
(port of ``mlcomp_tpu/db/fencing.py``).

Leader election alone does not close the split-brain window: a leader
paused mid-tick (GC stall, VM freeze, network partition) can resume
AFTER a standby acquired the lease and keep issuing writes from its
stale view — double-dispatching a task, resurrecting one a newer
leader already requeued, killing a replica the new leader just healed.
Fencing closes that window at the protocol level.

:class:`FencedSession` wraps the supervisor's session and rewrites
every mutation of a CONTROL-STATE table so it carries the fence
predicate::

    UPDATE task SET ... WHERE id=?
      AND (SELECT epoch FROM supervisor_lease WHERE id=1)=?

    INSERT INTO queue_message (cols) VALUES (?, ...)
      ->  INSERT INTO queue_message (cols) SELECT ?, ...
          WHERE (SELECT epoch FROM supervisor_lease WHERE id=1)=?

The epoch parameter is the wrapper's CURRENT belief (read from the
:class:`~mlcomp_tpu_torch.server.ha.LeaderLease` at statement time); the
subquery is the store's truth. sqlite evaluates the predicate inside
the single mutating statement, so once a newer leader's acquisition
commits, every later statement from the zombie matches zero rows —
ordinary single-statement atomicity is the only mechanism required.
(A statement already in
flight when the acquisition commits may still land; that window is a
single statement wide — the guarantee fencing-at-the-store gives
without serializable isolation, and the same one every
fencing-token design has.)

Scope: ``task``, ``queue_message``, ``serve_fleet``, ``serve_replica``
— the tables where a stale write changes what the cluster DOES.
Telemetry tables (metric, alert, span, auxiliary, log, postmortem)
pass through unfenced by design: a zombie's observability rows are
harmless, and fencing must never be the reason a failure goes
unrecorded.

A fenced statement that matches zero rows is re-checked against the
lease: if the epoch moved, :class:`FenceLostError` is raised — loud,
counted (``fence_rejections``), and fatal to the zombie's tick. A
zero-rowcount with the epoch intact is a benign conditional-update
loss and flows back to the caller unchanged.
"""

import re
import threading

from mlcomp_tpu_torch.db.core import insert_sql, update_sql

#: control-state tables whose supervisor-issued mutations are fenced.
#: sweep/sweep_decision belong here: a zombie ex-leader recording a
#: prune verdict — or acting on one — would kill a cell the live
#: leader may have judged differently. preemption likewise: a zombie
#: recording an eviction decision — or applying one — would kill a
#: victim the live leader never chose (double-preemption)
FENCED_TABLES = frozenset(
    {'task', 'queue_message', 'serve_fleet', 'serve_replica',
     'sweep', 'sweep_decision', 'preemption'})

#: the store-side fence predicate (one indexed read of a 1-row table)
FENCE_PREDICATE = '(SELECT epoch FROM supervisor_lease WHERE id=1)=?'

_TARGET = re.compile(
    r'^\s*(INSERT\s+INTO|UPDATE|DELETE\s+FROM)\s+"?([A-Za-z_]\w*)"?',
    re.IGNORECASE)
_VALUES = re.compile(r'\bVALUES\s*\(', re.IGNORECASE)
_RETURNING = re.compile(r'\s+RETURNING\s+', re.IGNORECASE)
_WHERE = re.compile(r'\bWHERE\b', re.IGNORECASE)

#: process-wide count of writes the fence rejected — sampled into the
#: ``supervisor.fenced_writes`` series and the roster
_REJECTIONS_LOCK = threading.Lock()
_REJECTIONS = {'count': 0}


def fence_rejections() -> int:
    with _REJECTIONS_LOCK:
        return _REJECTIONS['count']


def _record_rejection():
    with _REJECTIONS_LOCK:
        _REJECTIONS['count'] += 1


class FenceLostError(RuntimeError):
    """This process's leadership epoch is no longer the store's — a
    newer leader exists and every further mutation must stop."""


def fence_statement(sql: str, params, epoch):
    """(sql, params, fenced?) — rewrite one DML statement to carry the
    fence predicate when it targets a fenced table. Non-DML and
    non-fenced-table statements pass through untouched."""
    m = _TARGET.match(sql)
    if m is None or m.group(2).lower() not in FENCED_TABLES:
        return sql, params, False
    head, tail = sql, ''
    rm = _RETURNING.search(sql)
    if rm is not None:
        head, tail = sql[:rm.start()], sql[rm.start():]
    kind = m.group(1).upper()
    if kind.startswith('INSERT'):
        vm = _VALUES.search(head)
        if vm is None:      # already INSERT..SELECT — append the pred
            head = head + (' AND ' if _WHERE.search(head)
                           else ' WHERE ') + FENCE_PREDICATE
        else:
            close = head.rfind(')')
            inner = head[vm.end():close]
            head = (head[:vm.start()] + 'SELECT ' + inner
                    + ' WHERE ' + FENCE_PREDICATE + head[close + 1:])
    else:
        # the outer WHERE (if any) ends the statement for every
        # provider-authored UPDATE/DELETE on these tables — appending
        # binds the predicate to it; a WHERE-less statement gains one
        head = head + (' AND ' if _WHERE.search(head) else ' WHERE ') \
            + FENCE_PREDICATE
    return head + tail, tuple(params) + (int(epoch),), True


class FencedSession:
    """Session proxy stamping the leader's epoch into every mutation
    of a control-state table. Reads, events and telemetry writes pass
    through untouched; everything not overridden here delegates to the
    wrapped session (``dialect``, ``table_columns``, ``wait_event``,
    ``atomic`` ...)."""

    def __init__(self, session, lease):
        # the wrapped driver session and the live leadership handle —
        # epoch is read PER STATEMENT so a demotion observed by the HA
        # loop immediately poisons in-flight provider code too
        self._session = session
        self._lease = lease

    # every attribute not overridden (query/query_one/commit/dialect/
    # events/...) is the wrapped session's — including its identity
    # attributes, so keyed-singleton bookkeeping stays untouched
    def __getattr__(self, name):
        return getattr(self._session, name)

    @property
    def fenced(self):
        return True

    @property
    def fence_epoch(self):
        return self._lease.epoch

    def _epoch_or_dead(self):
        """The epoch to stamp. A wrapper whose lease is not held
        stamps an impossible epoch (-1): a non-leader supervisor must
        never mutate control state, and the store enforces it even if
        a code path reaches a write without checking leadership."""
        epoch = self._lease.epoch
        return -1 if epoch is None else int(epoch)

    def _verify(self, epoch: int):
        """After a zero-row fenced write: benign conditional loss, or
        fence rejection? One 1-row read answers; rejection is loud."""
        try:
            row = self._session.query_one(
                'SELECT epoch FROM supervisor_lease WHERE id=1')
        except Exception:
            return      # can't tell — let the caller's rowcount logic run
        live = row['epoch'] if row is not None else None
        if live is None or int(live) != epoch:
            _record_rejection()
            raise FenceLostError(
                f'write fenced off: this supervisor holds epoch '
                f'{epoch} but the lease is at {live!r} — a newer '
                f'leader exists; stopping')

    def execute(self, sql, params=()):
        fsql, fparams, fenced = fence_statement(
            sql, params, self._epoch_or_dead())
        cur = self._session.execute(fsql, fparams)
        if fenced and cur.rowcount == 0:
            self._verify(fparams[-1])
        return cur

    def executemany(self, sql, seq):
        seq = list(seq)
        epoch = self._epoch_or_dead()
        fsql, _probe, fenced = fence_statement(sql, (), epoch)
        if not fenced:
            return self._session.executemany(sql, seq)
        cur = self._session.executemany(
            fsql, [tuple(row) + (epoch,) for row in seq])
        # same loud-rejection contract as execute()/add(): a fenced
        # batch INSERT that inserted fewer rows than it was given can
        # only mean the epoch moved (each INSERT..SELECT row matches 1
        # or 0 on the fence alone — there is no benign zero for an
        # insert). UPDATE/DELETE batches keep rowcount semantics: a
        # conditional shortfall there is the caller's signal, and the
        # zero-row-because-fenced case is caught by _verify on the
        # next single-statement write.
        rowcount = getattr(cur, 'rowcount', None)
        if seq and rowcount is not None and 0 <= rowcount < len(seq) \
                and _TARGET.match(sql).group(1).upper().startswith(
                    'INSERT'):
            self._verify(epoch)
            _record_rejection()
            raise FenceLostError(
                f'fenced batch INSERT landed {rowcount}/{len(seq)} '
                f'rows')
        return cur

    # --------------------------------------------------------------- object
    def add(self, obj, commit=True):
        table = getattr(type(obj), '__tablename__', None)
        if table not in FENCED_TABLES:
            return self._session.add(obj, commit=commit)
        sql, vals = insert_sql(obj)
        assign_id = hasattr(obj, 'id') and \
            getattr(obj, 'id', None) is None
        cur = self.execute(sql, vals)       # fenced path
        if cur.rowcount == 0:
            # zero rows with the epoch intact cannot happen for a
            # plain INSERT — treat any zero as a fence loss
            self._verify(self._epoch_or_dead())
            raise FenceLostError(
                'fenced INSERT inserted no row')
        if assign_id and cur.lastrowid is not None:
            obj.id = cur.lastrowid
        return obj

    def add_all(self, objs):
        for o in objs:
            self.add(o)

    def update_obj(self, obj, fields=None):
        sql, vals = update_sql(obj, fields)
        self.execute(sql, vals)


__all__ = ['FencedSession', 'FenceLostError', 'fence_statement',
           'fence_rejections', 'FENCED_TABLES', 'FENCE_PREDICATE']

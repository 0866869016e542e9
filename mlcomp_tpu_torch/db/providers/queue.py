"""Queue provider — the DB-backed task transport (port of
``mlcomp_tpu/db/providers/queue.py``, its sqlite paths).

Named queues (``{host}_{docker}``, ``{host}_{docker}_{n}``,
``{host}_{docker}_supervisor``), at-most-once claim, revoke and result
status. A claim is one conditional ``UPDATE ... RETURNING`` on sqlite
>= 3.35; on older sqlite (no RETURNING) the same at-most-once semantics
come from a SELECT-candidate + conditional-UPDATE loop: any number of
workers may SELECT the same pending id, but the UPDATE's
``AND status='pending'`` guard lets exactly one win (rowcount 1).

A claim is a LEASE (``claimed_at``): the supervisor's recovery pass
returns claimed-but-expired messages of dead-heartbeat workers to
pending, exactly once per message (``redelivered``).

(The JAX package's PostgreSQL claim, ``FOR UPDATE SKIP LOCKED``, waits
with the PostgreSQL backend; its chaos seams wait with the chaos suite:
ROADMAP.md, A0.)
"""

import datetime
import json
import sqlite3

from mlcomp_tpu_torch.db.events import CH_QUEUE_DONE, queue_channel
from mlcomp_tpu_torch.db.models import QueueMessage
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.utils.misc import now

#: RETURNING landed in sqlite 3.35.0
_RETURNING_OK = sqlite3.sqlite_version_info >= (3, 35, 0)


def _is_returning_syntax_error(e: Exception) -> bool:
    return 'RETURNING' in str(e).upper()


class QueueProvider(BaseDataProvider):
    model = QueueMessage

    def _publish(self, channel: str):
        """Wake-on-work event (db/events.py), best-effort: a lost wakeup
        costs one poll interval, never correctness."""
        try:
            self.session.publish_event(channel)
        except Exception:
            pass

    def enqueue(self, queue: str, payload: dict) -> int:
        msg = QueueMessage(
            queue=queue, payload=json.dumps(payload), status='pending',
            created=now())
        self.add(msg)
        self._publish(queue_channel(queue))
        return msg.id

    def enqueue_many(self, items) -> int:
        """Batch enqueue of ``[(queue, payload_dict), ...]``: one INSERT
        batch, one wakeup per distinct queue. Returns the number
        inserted (use ``enqueue`` where the message id is needed)."""
        items = list(items)
        if not items:
            return 0
        stamp = now()
        self.session.executemany(
            "INSERT INTO queue_message (queue, payload, status, created) "
            "VALUES (?, ?, 'pending', ?)",
            [(queue, json.dumps(payload), stamp)
             for queue, payload in items])
        for queue in {queue for queue, _ in items}:
            self._publish(queue_channel(queue))
        return len(items)

    def claim(self, queues, worker: str):
        """Atomically claim the oldest pending message on any of
        ``queues``: (msg_id, payload dict) or None."""
        claims = self.claim_many(queues, worker, 1)
        return claims[0] if claims else None

    def claim_many(self, queues, worker: str, n: int):
        """Atomically claim up to ``n`` oldest pending messages across
        ``queues``: [(msg_id, payload dict), ...], oldest first."""
        if not queues or n < 1:
            return []
        global _RETURNING_OK
        if _RETURNING_OK:
            try:
                return self._claim_returning(queues, worker, n)
            except sqlite3.OperationalError as e:
                if not _is_returning_syntax_error(e):
                    raise
                _RETURNING_OK = False
        return self._claim_fallback(queues, worker, n)

    def _claim_returning(self, queues, worker: str, n: int):
        marks = ','.join('?' * len(queues))
        cur = self.session.execute(
            f"UPDATE queue_message SET status='claimed', claimed_by=?, "
            f"claimed_at=? WHERE id IN ("
            f"SELECT id FROM queue_message WHERE queue IN ({marks}) "
            f"AND status='pending' ORDER BY id LIMIT ?) "
            f"AND status='pending' RETURNING id, payload",
            (worker, now()) + tuple(queues) + (n,))
        rows = sorted(cur.fetchall(), key=lambda r: r['id'])
        return [(r['id'], json.loads(r['payload'])) for r in rows]

    def _claim_fallback(self, queues, worker: str, n: int):
        """sqlite < 3.35: pick a candidate batch, then claim it with a
        conditional UPDATE; raced-away candidates drop out of the won
        set and the loop moves to the next oldest."""
        marks = ','.join('?' * len(queues))
        claimed, skip = [], []
        while len(claimed) < n:
            not_in = ''
            params = list(queues)
            if skip:
                not_in = (' AND id NOT IN ('
                          + ','.join('?' * len(skip)) + ')')
                params += skip
            rows = self.session.query(
                f"SELECT id, payload FROM queue_message "
                f"WHERE queue IN ({marks}) AND status='pending'"
                f"{not_in} ORDER BY id LIMIT ?",
                tuple(params) + (n - len(claimed),))
            if not rows:
                break
            ids = [r['id'] for r in rows]
            payloads = {r['id']: r['payload'] for r in rows}
            id_marks = ','.join('?' * len(ids))
            cur = self.session.execute(
                f"UPDATE queue_message SET status='claimed', "
                f"claimed_by=?, claimed_at=? "
                f"WHERE id IN ({id_marks}) AND status='pending'",
                (worker, now()) + tuple(ids))
            if cur.rowcount == len(ids):
                won = set(ids)
            else:
                # some candidates raced away: a pending->claimed-by-me
                # transition on these ids can only be OUR update
                won = {r['id'] for r in self.session.query(
                    f"SELECT id FROM queue_message "
                    f"WHERE id IN ({id_marks}) AND claimed_by=? "
                    f"AND status='claimed'", tuple(ids) + (worker,))}
            for mid in ids:
                if mid in won:
                    claimed.append((mid, json.loads(payloads[mid])))
                else:
                    skip.append(mid)
        return claimed

    def find_active(self, queue: str, payload: dict):
        """id of a PENDING message with exactly this payload on this
        queue, or None: a supervisor that died between queue-put and
        the task's status write must not enqueue a second execution."""
        row = self.session.query_one(
            "SELECT id FROM queue_message WHERE queue=? AND payload=? "
            "AND status='pending' ORDER BY id LIMIT 1",
            (queue, json.dumps(payload)))
        return row['id'] if row else None

    def pending_index(self) -> dict:
        """{(queue, payload_json): oldest pending id}: one set query for
        a whole tick's ``find_active`` lookups."""
        rows = self.session.query(
            "SELECT id, queue, payload FROM queue_message "
            "WHERE status='pending' ORDER BY id DESC")
        return {(r['queue'], r['payload']): r['id'] for r in rows}

    def complete(self, msg_id: int, result: str = None,
                 worker: str = None) -> bool:
        """Finish a CLAIMED message, conditionally: with ``worker`` the
        transition is pinned to the claim holder, so a worker that
        stalled past its lease cannot mark the next claimant's run
        done. True when this caller's verdict won."""
        return self._finish(msg_id, 'done', result, worker)

    def fail(self, msg_id: int, result: str = None,
             worker: str = None) -> bool:
        return self._finish(msg_id, 'failed', result, worker)

    def _finish(self, msg_id: int, status: str, result,
                worker: str = None) -> bool:
        sql = (f"UPDATE queue_message SET status='{status}', result=? "
               f"WHERE id=? AND status='claimed'")
        params = [result, msg_id]
        if worker is not None:
            sql += ' AND claimed_by=?'
            params.append(worker)
        cur = self.session.execute(sql, tuple(params))
        if cur.rowcount > 0:
            # a completion frees capacity and may unblock dependants
            self._publish(CH_QUEUE_DONE)
            return True
        return False

    def revoke(self, msg_id: int) -> bool:
        """Revoke a pending message; a claimed one is stopped through
        the worker's kill path."""
        cur = self.session.execute(
            "UPDATE queue_message SET status='revoked' "
            "WHERE id=? AND status='pending'", (msg_id,))
        return cur.rowcount > 0

    # ------------------------------------------------------------- leases
    def claimed_expired(self, lease_seconds: float):
        """Claimed messages whose lease (claimed_at) expired."""
        cutoff = now() - datetime.timedelta(seconds=float(lease_seconds))
        rows = self.session.query(
            "SELECT * FROM queue_message WHERE status='claimed' "
            "AND claimed_at IS NOT NULL AND claimed_at < ? ORDER BY id",
            (cutoff,))
        return [QueueMessage.from_row(r) for r in rows]

    def reclaim(self, msg_id: int) -> bool:
        """Return an expired claim to pending EXACTLY ONCE (the
        ``redelivered=0`` guard). ``claimed_at`` is re-stamped to now:
        it times the re-delivery window of ``stranded_redelivered``."""
        cur = self.session.execute(
            "UPDATE queue_message SET status='pending', "
            "claimed_by=NULL, claimed_at=?, redelivered=1 "
            "WHERE id=? AND status='claimed' "
            "AND COALESCE(redelivered, 0)=0", (now(), msg_id))
        if cur.rowcount > 0:
            row = self.session.query_one(
                'SELECT queue FROM queue_message WHERE id=?', (msg_id,))
            if row is not None:
                self._publish(queue_channel(row['queue']))
            return True
        return False

    def expire_claim(self, msg_id: int) -> bool:
        """Fail a CLAIMED message that already spent its one
        re-delivery; a racing complete() or reclaim() wins cleanly."""
        cur = self.session.execute(
            "UPDATE queue_message SET status='failed', "
            "result='lease expired twice' "
            "WHERE id=? AND status='claimed' "
            "AND COALESCE(redelivered, 0)=1", (msg_id,))
        return cur.rowcount > 0

    def fail_stranded(self, msg_id: int) -> bool:
        """Fail a re-delivered message nobody claimed for a lease
        window, conditionally: a claim landing first wins."""
        cur = self.session.execute(
            "UPDATE queue_message SET status='failed', "
            "result='lease expired; queue dead after redelivery' "
            "WHERE id=? AND status='pending' "
            "AND COALESCE(redelivered, 0)=1", (msg_id,))
        return cur.rowcount > 0

    def stranded_redelivered(self, lease_seconds: float):
        """Re-delivered messages still pending a full lease window after
        their reclaim."""
        cutoff = now() - datetime.timedelta(seconds=float(lease_seconds))
        rows = self.session.query(
            "SELECT * FROM queue_message WHERE status='pending' "
            "AND COALESCE(redelivered, 0)=1 "
            "AND claimed_at IS NOT NULL AND claimed_at < ? ORDER BY id",
            (cutoff,))
        return [QueueMessage.from_row(r) for r in rows]

    def status(self, msg_id: int):
        row = self.session.query_one(
            'SELECT status FROM queue_message WHERE id=?', (msg_id,))
        return row['status'] if row else None

    def pending(self, queue: str):
        rows = self.session.query(
            "SELECT * FROM queue_message WHERE queue=? AND "
            "status='pending' ORDER BY id", (queue,))
        return [QueueMessage.from_row(r) for r in rows]

    def purge(self, before=None):
        if before is None:
            self.session.execute(
                "DELETE FROM queue_message WHERE status IN "
                "('done', 'failed', 'revoked')")
        else:
            self.session.execute(
                "DELETE FROM queue_message WHERE status IN "
                "('done', 'failed', 'revoked') AND created < ?", (before,))


__all__ = ['QueueProvider']

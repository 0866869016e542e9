"""Credential tiering for the multi-computer control plane.

The reference's shared-postgres deployment gave every machine DB-grade
auth; the rebuild's ``/api/db`` proxy initially had one static bearer
token with full SQL control. These tables tier it:

- ``WorkerToken`` — per-computer credentials restricted (by statement
  inspection in server/api.py) to DML on the framework's own tables;
  issued via ``python -m mlcomp_tpu_torch.server issue-token <computer>`` or
  ``POST /api/worker_token`` with the server token.
- ``DbAudit`` — append-only log of every WRITE statement proxied
  through ``/api/db``, whoever sent it.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class WorkerToken(DBModel):
    __tablename__ = 'worker_token'

    id = Column('INTEGER', primary_key=True)
    token = Column('TEXT', index=True)
    computer = Column('TEXT', index=True)
    created = Column('TEXT', dtype='datetime')
    revoked = Column('INTEGER', default=0, dtype='bool')


class DbAudit(DBModel):
    __tablename__ = 'db_audit'

    id = Column('INTEGER', primary_key=True)
    role = Column('TEXT')                 # 'server' | 'worker'
    computer = Column('TEXT')             # issued-to, for worker tokens
    op = Column('TEXT')                   # execute | executemany
    sql = Column('TEXT')
    time = Column('TEXT', dtype='datetime')

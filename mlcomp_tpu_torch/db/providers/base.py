"""Base provider: generic CRUD + pagination (parity: reference db/providers/base.py:13-134)."""

from mlcomp_tpu_torch.db.core import Session, adapt_value
from mlcomp_tpu_torch.db.options import PaginatorOptions


class BaseDataProvider:
    model = None  # subclass sets the DBModel class

    def __init__(self, session: Session = None):
        self.session = session or Session.create_session()

    # ------------------------------------------------------------- generic
    @property
    def table(self):
        return self.model.__tablename__

    def add(self, obj, commit: bool = True):
        return self.session.add(obj, commit=commit)

    def add_all(self, objs):
        self.session.add_all(objs)
        return objs

    def update(self, obj, fields=None):
        self.session.update_obj(obj, fields)
        return obj

    def commit(self):
        self.session.commit()

    def by_id(self, id_):
        row = self.session.query_one(
            f'SELECT * FROM {self.table} WHERE id=?', (id_,))
        return self.model.from_row(row) if row else None

    def all(self):
        rows = self.session.query(f'SELECT * FROM {self.table}')
        return [self.model.from_row(r) for r in rows]

    def count(self, where: str = '', params=()):
        sql = f'SELECT COUNT(*) AS c FROM {self.table}'
        if where:
            sql += f' WHERE {where}'
        return self.session.query_one(sql, params)['c']

    def remove(self, id_):
        self.session.execute(
            f'DELETE FROM {self.table} WHERE id=?', (id_,))

    def query(self, where: str = '', params=(),
              options: PaginatorOptions = None, default_sort: str = 'id'):
        sql = f'SELECT * FROM {self.table}'
        if where:
            sql += f' WHERE {where}'
        if options:
            sql += ' ' + options.sql(default_sort=default_sort)
        rows = self.session.query(sql, params)
        return [self.model.from_row(r) for r in rows]

    def create_or_update(self, obj, *match_fields, fields=None):
        """Update the row matching ``match_fields``, else insert
        (reference db/providers/base.py create_or_update).

        On update, only columns with a non-None value on ``obj`` are
        written (plus any explicitly listed in ``fields``) so that live
        state stored by other components — e.g. a computer's usage JSON —
        is not wiped by a re-registration that didn't set it.
        """
        where = ' AND '.join(f'"{f}"=?' for f in match_fields)
        params = tuple(adapt_value(getattr(obj, f)) for f in match_fields)
        row = self.session.query_one(
            f'SELECT * FROM {self.table} WHERE {where}', params)
        if row is None:
            return self.add(obj)
        pk = next(k for k, c in obj.__columns__.items() if c.primary_key)
        setattr(obj, pk, row[pk])
        if fields is None:
            fields = [k for k, c in obj.__columns__.items()
                      if not c.primary_key
                      and getattr(obj, k, None) is not None]
        if fields:
            self.update(obj, fields)
        return obj

    def serialize(self, objs):
        if isinstance(objs, list):
            return [o.to_dict() for o in objs]
        return objs.to_dict()


__all__ = ['BaseDataProvider', 'PaginatorOptions']

"""The port's metadata store: the JAX package's sqlite schema and
providers over stdlib ``sqlite3`` (``mlcomp_tpu/db``)."""

from mlcomp_tpu_torch.db.core import Session, Column, DBModel
from mlcomp_tpu_torch.db.options import PaginatorOptions

__all__ = ['Session', 'Column', 'DBModel', 'PaginatorOptions']

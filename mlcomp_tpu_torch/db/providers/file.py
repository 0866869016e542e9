"""File/DagStorage/DagLibrary providers (parity: reference db/providers/file.py:5-33,
db/providers/dag_storage.py:5-21)."""

from mlcomp_tpu_torch.db.models import DagLibrary, DagStorage, File
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class FileProvider(BaseDataProvider):
    model = File

    def hashs(self, project: int):
        """md5 -> file id map for dedup (reference file.py:10-18)."""
        rows = self.session.query(
            'SELECT id, md5 FROM file WHERE project=?', (project,))
        return {r['md5']: r['id'] for r in rows}


class DagStorageProvider(BaseDataProvider):
    model = DagStorage

    def by_dag(self, dag: int):
        """[(storage_row, file_row_or_none)] ordered by path
        (reference dag_storage.py:10-17)."""
        rows = self.session.query(
            'SELECT s.*, f.content AS content FROM dag_storage s '
            'LEFT JOIN file f ON s.file = f.id WHERE s.dag=? '
            'ORDER BY s.path', (dag,))
        out = []
        for r in rows:
            storage = DagStorage.from_row(r)
            out.append((storage, r['content']))
        return out


class DagLibraryProvider(BaseDataProvider):
    model = DagLibrary

    def dag(self, dag: int):
        rows = self.session.query(
            'SELECT library, version FROM dag_library WHERE dag=?', (dag,))
        return [(r['library'], r['version']) for r in rows]


__all__ = ['FileProvider', 'DagStorageProvider', 'DagLibraryProvider']

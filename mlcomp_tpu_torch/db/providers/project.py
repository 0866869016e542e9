"""Project provider (parity: reference db/providers/project.py:13-104)."""

from mlcomp_tpu_torch.db.models import Project
from mlcomp_tpu_torch.db.providers.base import BaseDataProvider


class ProjectProvider(BaseDataProvider):
    model = Project

    def add_project(self, name: str, class_names: str = None,
                    ignore_folders: str = None, sync_folders: str = None):
        p = Project(name=name, class_names=class_names,
                    ignore_folders=ignore_folders, sync_folders=sync_folders)
        return self.add(p)

    def by_name(self, name: str):
        row = self.session.query_one(
            'SELECT * FROM project WHERE name=?', (name,))
        return Project.from_row(row) if row else None


__all__ = ['ProjectProvider']

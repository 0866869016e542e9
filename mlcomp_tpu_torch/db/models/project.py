"""Project model (parity: reference db/models/project.py:7-13)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Project(DBModel):
    __tablename__ = 'project'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False, unique=True)
    class_names = Column('TEXT')      # yaml: class-index -> name mappings
    ignore_folders = Column('TEXT')   # yaml: folders excluded from code upload
    sync_folders = Column('TEXT')     # yaml: extra folders to sync

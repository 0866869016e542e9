"""Code-storage models (parity: reference db/models/file.py:9-25,
db/models/dag_storage.py:7-24).

Files are content-addressed by md5 and deduplicated; DagStorage maps a DAG's
relative paths to file blobs; DagLibrary records pip library versions seen in
the uploaded code so workers can reproduce the environment.
"""

from mlcomp_tpu_torch.db.core import Column, DBModel


class File(DBModel):
    __tablename__ = 'file'

    id = Column('INTEGER', primary_key=True)
    md5 = Column('TEXT', nullable=False, index=True)
    created = Column('TEXT', dtype='datetime')
    content = Column('BLOB', nullable=False)
    project = Column('INTEGER', foreign_key='project.id', index=True)
    dag = Column('INTEGER', index=True)
    size = Column('INTEGER', default=0)


class DagStorage(DBModel):
    __tablename__ = 'dag_storage'

    id = Column('INTEGER', primary_key=True)
    dag = Column('INTEGER', foreign_key='dag.id', index=True, nullable=False)
    path = Column('TEXT', nullable=False)
    file = Column('INTEGER', foreign_key='file.id', index=True)
    is_dir = Column('INTEGER', default=0, dtype='bool')


class DagLibrary(DBModel):
    __tablename__ = 'dag_library'

    id = Column('INTEGER', primary_key=True)
    dag = Column('INTEGER', foreign_key='dag.id', index=True, nullable=False)
    library = Column('TEXT', nullable=False)
    version = Column('TEXT')

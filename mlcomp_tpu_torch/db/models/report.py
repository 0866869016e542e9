"""Report family models (parity: reference db/models/report.py:11-91)."""

from mlcomp_tpu_torch.db.core import Column, DBModel


class Report(DBModel):
    __tablename__ = 'report'

    id = Column('INTEGER', primary_key=True)
    config = Column('TEXT')   # yaml layout instance
    time = Column('TEXT', dtype='datetime')
    name = Column('TEXT')
    project = Column('INTEGER', foreign_key='project.id', index=True)
    layout = Column('TEXT')   # ReportLayout.name


class ReportSeries(DBModel):
    """Metric series: one row per (name, epoch, part, stage, task)."""

    __tablename__ = 'report_series'

    id = Column('INTEGER', primary_key=True)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)
    time = Column('TEXT', dtype='datetime')
    epoch = Column('INTEGER', default=0)
    value = Column('REAL')
    name = Column('TEXT', index=True)
    part = Column('TEXT')     # train/valid
    stage = Column('TEXT')


class ReportImg(DBModel):
    """Binary image artifacts with prediction metadata for UI galleries."""

    __tablename__ = 'report_img'

    id = Column('INTEGER', primary_key=True)
    group = Column('TEXT', index=True)
    epoch = Column('INTEGER', default=0)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)
    img = Column('BLOB')
    project = Column('INTEGER', index=True)
    dag = Column('INTEGER', index=True)
    part = Column('TEXT')
    y = Column('INTEGER')
    y_pred = Column('INTEGER')
    score = Column('REAL')
    attr1 = Column('REAL')
    attr2 = Column('REAL')
    attr3 = Column('REAL')
    attr1_str = Column('TEXT')
    attr2_str = Column('TEXT')
    attr3_str = Column('TEXT')
    size = Column('INTEGER', default=0)


class ReportTasks(DBModel):
    __tablename__ = 'report_tasks'

    id = Column('INTEGER', primary_key=True)
    report = Column('INTEGER', foreign_key='report.id', index=True,
                    nullable=False)
    task = Column('INTEGER', foreign_key='task.id', index=True,
                  nullable=False)


class ReportLayout(DBModel):
    """Named yaml report layouts, editable live in the UI."""

    __tablename__ = 'report_layout'

    id = Column('INTEGER', primary_key=True)
    name = Column('TEXT', nullable=False, unique=True)
    content = Column('TEXT', nullable=False)
    last_modified = Column('TEXT', dtype='datetime')

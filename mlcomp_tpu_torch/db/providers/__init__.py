"""Data providers — one repository per entity (port of
``mlcomp_tpu/db/providers``: the ones the CLI, the DAG builder, the task
pipeline and the trainer use). The queue, fleet, supervisor, sweep,
usage, quota, auth and docker providers come with the second half of A0
(ROADMAP.md)."""

from mlcomp_tpu_torch.db.providers.base import BaseDataProvider
from mlcomp_tpu_torch.db.providers.project import ProjectProvider
from mlcomp_tpu_torch.db.providers.dag import DagPreflightProvider, DagProvider
from mlcomp_tpu_torch.db.providers.task import TaskProvider
from mlcomp_tpu_torch.db.providers.file import (
    FileProvider, DagStorageProvider, DagLibraryProvider
)
from mlcomp_tpu_torch.db.providers.log import LogProvider
from mlcomp_tpu_torch.db.providers.step import StepProvider
from mlcomp_tpu_torch.db.providers.report import (
    ReportProvider, ReportSeriesProvider, ReportTasksProvider,
    ReportLayoutProvider
)
from mlcomp_tpu_torch.db.providers.model import ModelProvider
from mlcomp_tpu_torch.db.providers.telemetry import (
    MetricProvider, TelemetrySpanProvider,
)

__all__ = [
    'MetricProvider', 'TelemetrySpanProvider', 'DagPreflightProvider',
    'BaseDataProvider', 'ProjectProvider', 'DagProvider', 'TaskProvider',
    'FileProvider', 'DagStorageProvider', 'DagLibraryProvider',
    'LogProvider', 'StepProvider', 'ReportProvider',
    'ReportSeriesProvider', 'ReportTasksProvider',
    'ReportLayoutProvider', 'ModelProvider',
]

"""Data providers — one repository per entity (port of
``mlcomp_tpu/db/providers``: the ones the CLI, the DAG builder, the task
pipeline, the trainer, the supervisor, its leader lease, the worker
daemon, the API, the serving fleets, the ASHA sweeps, the quotas, the
preemption engine and the usage ledger use). The auth providers come
with their ROADMAP.md item (A0)."""

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
    ReportProvider, ReportSeriesProvider, ReportImgProvider,
    ReportTasksProvider, ReportLayoutProvider
)
from mlcomp_tpu_torch.db.providers.model import ModelProvider
from mlcomp_tpu_torch.db.providers.telemetry import (
    AlertProvider, MetricProvider, PostmortemProvider, TelemetrySpanProvider,
)
from mlcomp_tpu_torch.db.providers.auxiliary import AuxiliaryProvider
from mlcomp_tpu_torch.db.providers.computer import ComputerProvider
from mlcomp_tpu_torch.db.providers.docker import DockerProvider
from mlcomp_tpu_torch.db.providers.queue import QueueProvider
from mlcomp_tpu_torch.db.providers.task_synced import TaskSyncedProvider
from mlcomp_tpu_torch.db.providers.supervisor import SupervisorLeaseProvider
from mlcomp_tpu_torch.db.providers.fleet import FleetProvider, ReplicaProvider
from mlcomp_tpu_torch.db.providers.sweep import (
    SweepDecisionProvider, SweepProvider,
)
from mlcomp_tpu_torch.db.providers.usage import UsageProvider
from mlcomp_tpu_torch.db.providers.quota import (
    PreemptionProvider, QuotaProvider,
)

__all__ = [
    'MetricProvider', 'TelemetrySpanProvider', 'DagPreflightProvider',
    'BaseDataProvider', 'ProjectProvider', 'DagProvider', 'TaskProvider',
    'FileProvider', 'DagStorageProvider', 'DagLibraryProvider',
    'LogProvider', 'StepProvider', 'ReportProvider',
    'ReportSeriesProvider', 'ReportImgProvider', 'ReportTasksProvider',
    'ReportLayoutProvider', 'ModelProvider', 'AlertProvider',
    'AuxiliaryProvider', 'ComputerProvider', 'DockerProvider',
    'QueueProvider', 'TaskSyncedProvider', 'SupervisorLeaseProvider',
    'PostmortemProvider', 'FleetProvider', 'ReplicaProvider',
    'SweepProvider', 'SweepDecisionProvider', 'UsageProvider',
    'QuotaProvider', 'PreemptionProvider',
]

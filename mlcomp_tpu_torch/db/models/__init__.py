"""DB schema: declarative models (parity: reference db/models/__init__.py:1-19)."""

from mlcomp_tpu_torch.db.models.project import Project
from mlcomp_tpu_torch.db.models.dag import Dag, DagPreflight
from mlcomp_tpu_torch.db.models.task import Task, TaskDependence, TaskSynced
from mlcomp_tpu_torch.db.models.computer import Computer, ComputerUsage
from mlcomp_tpu_torch.db.models.docker import Docker
from mlcomp_tpu_torch.db.models.file import File, DagStorage, DagLibrary
from mlcomp_tpu_torch.db.models.log import Log
from mlcomp_tpu_torch.db.models.step import Step
from mlcomp_tpu_torch.db.models.report import (
    Report, ReportImg, ReportSeries, ReportTasks, ReportLayout
)
from mlcomp_tpu_torch.db.models.model import Model
from mlcomp_tpu_torch.db.models.auxiliary import Auxiliary
from mlcomp_tpu_torch.db.models.queue import QueueMessage
from mlcomp_tpu_torch.db.models.auth import DbAudit, WorkerToken
from mlcomp_tpu_torch.db.models.telemetry import (
    Alert, Metric, Postmortem, TelemetrySpan,
)
from mlcomp_tpu_torch.db.models.fleet import ServeFleet, ServeReplica
from mlcomp_tpu_torch.db.models.supervisor import (
    SupervisorInstance, SupervisorLease,
)
from mlcomp_tpu_torch.db.models.sweep import Sweep, SweepDecision
from mlcomp_tpu_torch.db.models.usage import Usage
from mlcomp_tpu_torch.db.models.quota import Preemption, Quota

ALL_MODELS = [
    Project, Report, ReportLayout, Dag, Task, TaskDependence, TaskSynced,
    Computer, ComputerUsage, Docker, File, DagStorage, DagLibrary, Log, Step,
    ReportImg, ReportSeries, ReportTasks, Model, Auxiliary, QueueMessage,
    WorkerToken, DbAudit, Metric, TelemetrySpan, DagPreflight, Alert,
    Postmortem,
    ServeFleet, ServeReplica,
    SupervisorLease, SupervisorInstance,
    Sweep, SweepDecision,
    Usage,
    Quota, Preemption,
]

__all__ = [m.__name__ for m in ALL_MODELS] + ['ALL_MODELS']

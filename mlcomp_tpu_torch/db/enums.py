"""Status/type enums for the DB schema (parity: reference db/enums.py:41-73)."""

from enum import IntEnum


class OrderedEnum(IntEnum):
    """Int-valued enum with ordering — stored as ints in the DB."""

    @classmethod
    def names(cls):
        return [e.name for e in cls]

    @classmethod
    def from_name(cls, name: str):
        return cls[name]


class DagType(OrderedEnum):
    Standard = 0
    Pipe = 1


class TaskStatus(OrderedEnum):
    NotRan = 0
    Queued = 1
    InProgress = 2
    Failed = 3
    Stopped = 4
    Skipped = 5
    Success = 6

    @classmethod
    def finished(cls):
        return [cls.Failed, cls.Stopped, cls.Skipped, cls.Success]

    @classmethod
    def unfinished(cls):
        return [cls.NotRan, cls.Queued, cls.InProgress]


class TaskType(OrderedEnum):
    User = 0
    Train = 1
    Service = 2


class ComponentType(OrderedEnum):
    API = 0
    Supervisor = 1
    Worker = 2
    WorkerSupervisor = 3


class LogStatus(OrderedEnum):
    Debug = 0
    Info = 1
    Warning = 2
    Error = 3

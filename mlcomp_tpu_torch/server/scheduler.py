"""Priority classes of the scheduler (port of
``mlcomp_tpu/server/scheduler.py``'s ``normalize_priority``, which the
DAG builder validates with; the scheduling policy itself comes with the
supervisor, ROADMAP.md A0)."""

#: scheduling classes, strongest first
PRIORITY_CLASSES = ('critical', 'high', 'normal', 'preemptible')

#: rank: higher = scheduled earlier, preempts lower
PRIORITY_RANK = {'critical': 3, 'high': 2, 'normal': 1, 'preemptible': 0}


def normalize_priority(value, default: str = None):
    """Validated class name or ``default`` (None passes through for
    "no explicit class, use the class-based default")."""
    if value is None or value == '':
        return default
    name = str(value).strip().lower()
    if name not in PRIORITY_RANK:
        raise ValueError(
            f'unknown priority class {value!r} — expected one of '
            f'{", ".join(PRIORITY_CLASSES)}')
    return name


__all__ = ['normalize_priority', 'PRIORITY_CLASSES', 'PRIORITY_RANK']

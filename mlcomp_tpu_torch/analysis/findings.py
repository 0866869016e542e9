"""Finding/rule primitives of the DAG preflight (port of
``mlcomp_tpu/analysis/findings.py``, its ``dag-*`` rules).

A ``Finding`` is one diagnostic: a stable rule id, a severity, the
location it anchors to, a one-line message, and a short "why" that
explains the cost of ignoring it. Errors reject a DAG at submit time;
warnings ride along (stored with the dag row, printed by the CLI) but
never block a submission. The JAX package's code lints (``jax-*``,
``cc-*``, ``db-*``) have no torch counterpart yet (ROADMAP.md, A8): the
report says that they were not run.
"""

#: the line every report of the port's gate ends with
CODE_LINT_NOT_RUN = ('code lint not run: the port has no lint of torch '
                     'hot paths yet (ROADMAP.md, A8)')

SEV_ERROR = 'error'
SEV_WARNING = 'warning'

#: rule id -> (default severity, one-line "why it matters")
RULES = {
    # ------------------------------------------------- DAG preflight engine
    'dag-config': (
        SEV_ERROR,
        'a malformed config fails at submit parsing or worker import — '
        'minutes later on a scheduled TPU slot'),
    'dag-project-missing': (
        SEV_ERROR,
        'the builder asserts info.project; without it the DAG row can '
        'never be created'),
    'dag-executor-unknown': (
        SEV_ERROR,
        'the executor class is resolved only when a worker picks the '
        'task up — a typo fails after queueing, not at submit'),
    'dag-depends-self': (
        SEV_ERROR, 'a task can never unblock itself'),
    'dag-depends-unknown': (
        SEV_ERROR,
        'a dangling depends edge can never be satisfied; the task '
        'would wait forever'),
    'dag-cycle': (
        SEV_ERROR,
        'tasks in a dependency cycle all wait on each other and '
        'never run'),
    'dag-cores': (
        SEV_ERROR,
        'an unparsable cores spec fails at task creation'),
    'dag-mesh': (
        SEV_ERROR,
        'a mesh/cores combination that cannot be placed fails hours '
        'later at executor mesh build instead of at submit'),
    'dag-grid': (
        SEV_ERROR,
        'a malformed grid axis fails at cell fan-out'),
    'dag-ambiguous-override': (
        SEV_ERROR,
        "merge_dicts_smart raises on an ambiguous suffix match — the "
        "grid cell / --params override would crash the worker at "
        "executor construction"),

}


class Finding:
    __slots__ = ('rule', 'severity', 'message', 'path', 'line')

    def __init__(self, rule: str, message: str, path: str = None,
                 line: int = None, severity: str = None):
        if rule not in RULES:
            raise KeyError(f'unknown preflight rule {rule!r}')
        self.rule = rule
        self.severity = severity or RULES[rule][0]
        self.message = message
        self.path = path
        self.line = line

    @property
    def why(self) -> str:
        return RULES[self.rule][1]

    @property
    def is_error(self) -> bool:
        return self.severity == SEV_ERROR

    def location(self) -> str:
        if self.path and self.line:
            return f'{self.path}:{self.line}'
        return self.path or ''

    def format(self, with_why: bool = True) -> str:
        loc = self.location()
        head = f'{self.severity.upper():7s} [{self.rule}]'
        if loc:
            head += f' {loc}'
        text = f'{head}: {self.message}'
        if with_why:
            text += f'\n        why: {self.why}'
        return text

    def to_dict(self) -> dict:
        return {'rule': self.rule, 'severity': self.severity,
                'message': self.message, 'path': self.path,
                'line': self.line, 'why': self.why}

    def __repr__(self):
        return f'Finding({self.rule!r}, {self.location()!r})'


def split_findings(findings):
    """(errors, warnings) partition preserving order."""
    errors = [f for f in findings if f.is_error]
    warnings = [f for f in findings if not f.is_error]
    return errors, warnings


def sort_findings(findings):
    """Deterministic report order: errors first, then (file, line,
    rule, message) within a severity. Engines walk dicts and thread
    pools, so raw finding order can vary run to run — CI gates diff
    their reports, and a reordered report must not read as a change."""
    return sorted(findings, key=lambda f: (
        0 if f.is_error else 1, f.path or '', f.line or 0,
        f.rule, f.message))


class PreflightError(ValueError):
    """A DAG rejected by static analysis before any DB insert.
    ``findings`` carries the error-severity Findings."""

    def __init__(self, findings):
        super().__init__(
            'preflight rejected the DAG:\n' + format_report(findings))
        self.findings = findings


def format_report(findings, with_why: bool = True) -> str:
    if not findings:
        return f'preflight: no findings; {CODE_LINT_NOT_RUN}'
    errors, warnings = split_findings(findings)
    lines = [f.format(with_why=with_why) for f in findings]
    lines.append(f'preflight: {len(errors)} error(s), '
                 f'{len(warnings)} warning(s); {CODE_LINT_NOT_RUN}')
    return '\n'.join(lines)


__all__ = ['Finding', 'CODE_LINT_NOT_RUN', 'PreflightError', 'RULES',
           'SEV_ERROR', 'SEV_WARNING', 'split_findings', 'sort_findings',
           'format_report']

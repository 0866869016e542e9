"""Preflight static analysis of DAGs (port of ``mlcomp_tpu/analysis``,
its DAG engine): fail a bad DAG at submit, not on a card. Wired through
``python -m mlcomp_tpu_torch check CONFIG`` and the ``dag``/``execute``
submit gate (errors reject before any DB insert; warnings are stored
with the dag row). The JAX package's code lints have no torch
counterpart yet (ROADMAP.md, A8)."""

from mlcomp_tpu_torch.analysis.findings import (
    CODE_LINT_NOT_RUN, RULES, Finding, PreflightError, format_report,
    sort_findings, split_findings,
)
from mlcomp_tpu_torch.analysis.dag_check import (
    builtin_executor_names, folder_sources, gate_config,
    preflight_config, resolvable_executor_names, snapshot_sources,
)

__all__ = [
    'Finding', 'PreflightError', 'RULES', 'CODE_LINT_NOT_RUN',
    'format_report', 'split_findings', 'sort_findings',
    'preflight_config', 'gate_config', 'resolvable_executor_names',
    'builtin_executor_names', 'folder_sources', 'snapshot_sources',
]

"""DAG preflight (port of ``mlcomp_tpu/analysis/dag_check.py``):
validate a config and its code snapshot WITHOUT importing user code or
the training stack.

- executor names resolve by AST inspection, mirroring the registry
  semantics (``@Executor.register`` under ``to_snake(class name)``) and
  ``Storage.import_executor``'s fallback — over the port's builtin
  executor modules, where ``jax_train`` names the port's ``train``
- dependency edges are checked for self/dangling/cycles
- ``cores`` specs parse and ``mesh`` requests validate against them
  via the meshspec grain rules (parallel/meshspec.py)
- grid cells and ``--params`` overrides are dry-run through
  ``merge_dicts_smart`` so an ambiguous suffix match is a submit-time
  finding instead of a worker crash

The JAX package's hot-path lint of the code snapshot has no torch
counterpart yet (ROADMAP.md, A8); ``format_report`` says so.
"""

import ast
import os

from mlcomp_tpu_torch.analysis.findings import Finding
from mlcomp_tpu_torch.utils.misc import to_snake

_builtin_names_cache = None


def class_names_in_source(text: str) -> set:
    """snake_case names of every class defined in ``text`` (empty set on
    syntax errors — an unparsable module cannot define an executor for
    the AST-based import path either)."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return set()
    return {to_snake(node.name) for node in ast.walk(tree)
            if isinstance(node, ast.ClassDef)}


def builtin_executor_names() -> frozenset:
    """snake names the lazy builtin registry would provide, computed by
    AST over the port's builtin module FILES (mirrors
    Executor._load_builtins without importing the training stack), plus
    the registry's aliases (``jax_train``)."""
    global _builtin_names_cache
    if _builtin_names_cache is not None:
        return _builtin_names_cache
    import mlcomp_tpu_torch
    from mlcomp_tpu_torch.worker.executors import Executor
    root = os.path.dirname(os.path.abspath(mlcomp_tpu_torch.__file__))
    names = set(Executor._aliases)
    for mod in Executor._builtin_modules:
        rel = mod.split('.')[1:]  # drop the package name
        path = os.path.join(root, *rel) + '.py'
        try:
            with open(path, encoding='utf-8', errors='ignore') as fh:
                names |= class_names_in_source(fh.read())
        except OSError:
            continue
    _builtin_names_cache = frozenset(names)
    return _builtin_names_cache


def folder_sources(folder: str) -> dict:
    """{relative path: source text} for every .py under ``folder``
    (skips hidden dirs and __pycache__, like Storage._scan_folder)."""
    out = {}
    if not folder or not os.path.isdir(folder):
        return out
    for root, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if not d.startswith('.')
                   and d != '__pycache__']
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(root, f)
            try:
                with open(path, encoding='utf-8', errors='ignore') as fh:
                    out[os.path.relpath(path, folder)] = fh.read()
            except OSError:
                continue
    return out


def snapshot_sources(session, dag_id: int) -> dict:
    """{path: source} of a dag's stored code snapshot (dag_storage) —
    lets the supervisor/API preflight a DAG straight from the DB."""
    from mlcomp_tpu_torch.db.providers import DagStorageProvider
    out = {}
    for storage, content in DagStorageProvider(session).by_dag(dag_id):
        if storage.is_dir or not storage.path.endswith('.py'):
            continue
        if content is None:
            continue
        # errors='ignore' mirrors folder_sources: the submit gate and
        # the dispatch-time check must see the SAME module set, or a
        # stray non-UTF-8 byte makes the supervisor Skip a DAG the
        # gate accepted
        text = content.decode(errors='ignore') \
            if isinstance(content, (bytes, bytearray)) else str(content)
        out[storage.path] = text
    return out


def resolvable_executor_names(sources: dict = None) -> set:
    """Union of everything the worker's import path could resolve:
    classes already in the in-process registry, builtin executor module
    classes (AST), and classes defined in the code snapshot (AST)."""
    from mlcomp_tpu_torch.worker.executors import Executor
    names = set(Executor._registry)
    names |= builtin_executor_names()
    for text in (sources or {}).values():
        names |= class_names_in_source(text)
    return names


def _normalize_depends(depends):
    if not depends:
        return []
    if isinstance(depends, str):
        return [depends]
    return list(depends)


def _find_cycle(executors: dict) -> list:
    """Members of a dependency cycle (Kahn's peel), [] when acyclic."""
    # edges only between well-formed (dict-spec) executors: a dep on a
    # malformed spec is that spec's dag-config problem, not a cycle
    nodes = {name for name, spec in executors.items()
             if isinstance(spec, dict)}
    pending = {
        name: set(d for d in _normalize_depends(executors[name].get(
            'depends')) if d in nodes and d != name)
        for name in nodes
    }
    progressed = True
    while pending and progressed:
        progressed = False
        for name in [n for n, deps in pending.items() if not deps]:
            del pending[name]
            for deps in pending.values():
                deps.discard(name)
            progressed = True
    return sorted(pending)


def _check_overrides(spec: dict, overrides: dict, executor: str,
                     source: str, findings: list):
    """Dry-run merge_dicts_smart the way Executor.from_config /
    the CLI would apply ``overrides``; ambiguity becomes a finding."""
    from mlcomp_tpu_torch.utils.config import merge_dicts_smart
    try:
        merge_dicts_smart(dict(spec), dict(overrides))
    except ValueError as e:
        findings.append(Finding(
            'dag-ambiguous-override',
            f'executor {executor!r}: {source} override would fail: {e}',
            path=f'executors/{executor}'))


def preflight_config(config, sources: dict = None,
                     params: dict = None) -> list:
    """Run every DAG preflight rule over ``config``.

    ``sources``: {path: text} of the code snapshot that will ship with
    the DAG (``folder_sources``/``snapshot_sources``); ``params``: flat
    ``--params`` overrides destined for ``merge_dicts_smart``. Returns a
    list of Findings.
    """
    findings = []
    if not isinstance(config, dict):
        return [Finding('dag-config',
                        f'config must be a mapping, got '
                        f'{type(config).__name__}')]
    if 'pipes' in config:
        # pipe registration runs nothing — only the model-start path
        # instantiates equations, which have their own validation
        return findings

    info = config.get('info') or {}
    if not isinstance(info, dict) or not info.get('project'):
        findings.append(Finding(
            'dag-project-missing', 'info.project is required',
            path='info/project'))

    executors = config.get('executors')
    if not isinstance(executors, dict) or not executors:
        findings.append(Finding(
            'dag-config', 'config must declare a non-empty '
                          '"executors" mapping', path='executors'))
        return findings

    known = resolvable_executor_names(sources)
    from mlcomp_tpu_torch.server.create_dags.standard import parse_cores

    for name, spec in executors.items():
        loc = f'executors/{name}'
        if not isinstance(spec, dict):
            findings.append(Finding(
                'dag-config',
                f'executor {name!r} spec must be a mapping, got '
                f'{type(spec).__name__}', path=loc))
            continue

        # ---- dependency edges
        for dep in _normalize_depends(spec.get('depends')):
            if dep == name:
                findings.append(Finding(
                    'dag-depends-self',
                    f'executor {name!r} depends on itself', path=loc))
            elif dep not in executors:
                findings.append(Finding(
                    'dag-depends-unknown',
                    f'executor {name!r} depends on unknown {dep!r}',
                    path=loc))

        # ---- executor type resolution (registry semantics, no import)
        executor_type = spec.get('type', name)
        if not isinstance(executor_type, str) \
                or to_snake(executor_type) not in known:
            findings.append(Finding(
                'dag-executor-unknown',
                f'executor {name!r}: type {executor_type!r} matches no '
                f'builtin executor and no class in the code snapshot',
                path=loc))

        # ---- cores spec + mesh placement arithmetic
        cores = cores_max = 0
        try:
            cores, cores_max = parse_cores(
                spec.get('cores', spec.get('gpu', 0)))
        except (ValueError, TypeError) as e:
            findings.append(Finding(
                'dag-cores', f'executor {name!r}: {e}', path=loc))
        mesh = spec.get('mesh')
        if mesh is not None:
            from mlcomp_tpu_torch.parallel.meshspec import (
                validate_mesh_request,
            )
            try:
                validate_mesh_request(
                    mesh, cores, cores_max,
                    single_node=bool(spec.get('single_node', True)))
            except ValueError as e:
                findings.append(Finding(
                    'dag-mesh', f'executor {name!r}: {e}', path=loc))

        # ---- grid cells dry-run through the suffix merge
        grid = spec.get('grid')
        if grid is not None:
            from mlcomp_tpu_torch.contrib.search.grid import grid_cells
            try:
                cells = grid_cells(grid)
            except ValueError as e:
                findings.append(Finding(
                    'dag-grid', f'executor {name!r}: {e}', path=loc))
            except OSError as e:
                # _file/_folder axes read yml from disk — unreadable
                # here does not prove unreadable at submit cwd
                findings.append(Finding(
                    'dag-grid',
                    f'executor {name!r}: grid axis file unreadable '
                    f'({e})', path=loc, severity='warning'))
            else:
                for cell, cell_name in cells:
                    if cell:
                        _check_overrides(
                            spec, cell, name,
                            f'grid cell {cell_name!r}', findings)

    # ---- dependency cycles (over the whole graph)
    cycle = _find_cycle(executors)
    if cycle:
        findings.append(Finding(
            'dag-cycle',
            f'dependency cycle among executors: {cycle}',
            path='executors'))

    # ---- --params overrides against the WHOLE config (CLI semantics)
    if params:
        from mlcomp_tpu_torch.utils.config import merge_dicts_smart
        try:
            merge_dicts_smart(dict(config), dict(params))
        except ValueError as e:
            findings.append(Finding(
                'dag-ambiguous-override',
                f'--params override would fail: {e}'))

    return findings


def gate_config(config, sources: dict = None, params: dict = None) -> list:
    """THE submit-gate policy, shared by every entry point (CLI ``dag``,
    DagStandardBuilder): run preflight, raise ``PreflightError`` on any
    error finding, return the warnings for the caller to store with the
    dag row once it exists."""
    from mlcomp_tpu_torch.analysis.findings import (
        PreflightError, split_findings,
    )
    errors, warnings = split_findings(
        preflight_config(config, sources=sources, params=params))
    if errors:
        raise PreflightError(errors)
    return warnings


__all__ = ['preflight_config', 'gate_config',
           'resolvable_executor_names', 'builtin_executor_names',
           'folder_sources', 'snapshot_sources', 'class_names_in_source']

"""Standard DAG builder (port of
``mlcomp_tpu/server/create_dags/standard.py``).

yaml config → Project (auto-created) / Report (from layout) / Dag rows;
uploads the experiment folder into the DB; creates tasks topologically with
dependency validation; fans out one task per grid cell; parses the core
spec ``"a-b"`` into (cores, cores_max); wires per-train-task reports.
Every row is the one the JAX package's builder writes (the random
``trace_id`` aside). A ``sweep:`` block on a grid executor writes the
``sweep`` row the supervisor's ASHA scheduler (server/sweep.py) drives
and stamps the normalized spec on every cell.
"""

import os

from mlcomp_tpu_torch.contrib.search.grid import grid_cells
from mlcomp_tpu_torch.db.enums import DagType, TaskStatus, TaskType
from mlcomp_tpu_torch.db.models import Dag, Report, ReportTasks, Task
from mlcomp_tpu_torch.db.providers import (
    DagProvider, ProjectProvider, ReportLayoutProvider, ReportProvider,
    ReportTasksProvider, TaskProvider
)
from mlcomp_tpu_torch.server.scheduler import normalize_priority
from mlcomp_tpu_torch.utils.io import yaml_dump
from mlcomp_tpu_torch.utils.misc import now
from mlcomp_tpu_torch.worker.executors import Executor
from mlcomp_tpu_torch.worker.storage import Storage


def parse_cores(value):
    """'2-4' → (2, 4); 3 → (3, 3); None/0 → (0, 0)."""
    if value in (None, '', 0):
        return 0, 0
    if isinstance(value, int):
        return value, value
    text = str(value)
    if '-' in text:
        lo, hi = text.split('-', 1)
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(text)
    if lo > hi or lo < 0:
        raise ValueError(f'invalid core spec {value!r}')
    return lo, hi


from mlcomp_tpu_torch.analysis import PreflightError  # noqa: E402


class DagStandardBuilder:
    def __init__(self, session, config: dict, debug: bool = False,
                 config_text: str = None, upload_folder: str = None,
                 logger=None, component=None, preflight: bool = False,
                 preflight_params: dict = None, preflight_warnings=None):
        self.session = session
        self.config = config
        self.debug = debug
        self.config_text = config_text
        self.upload_folder = upload_folder
        self.logger = logger
        self.preflight = preflight
        self.preflight_params = preflight_params
        # warnings from a gate the CALLER already ran (the CLI gates the
        # raw config before merging --params); stored with the dag row
        # by the same path run_preflight's own findings take
        self.preflight_warnings = list(preflight_warnings or [])

        self.info = config.get('info', {})
        self.project_provider = ProjectProvider(session)
        self.dag_provider = DagProvider(session)
        self.task_provider = TaskProvider(session)
        self.report_provider = ReportProvider(session)
        self.report_tasks_provider = ReportTasksProvider(session)
        self.layout_provider = ReportLayoutProvider(session)
        self.storage = Storage(session, logger)

        self.project = None
        self.dag = None
        self.dag_report_id = None
        self.tasks = {}  # executor name -> [task ids]
        # one trace per submission (telemetry/spans.py): every task of
        # this dag carries the id in additional_info; the supervisor
        # puts it on the queue payload, the worker exports it into the
        # task environment — supervisor/worker/train spans join into
        # one cross-process tree (GET /telemetry/trace/<id>)
        from mlcomp_tpu_torch.telemetry import new_trace_id
        self.trace_id = new_trace_id()

    # ------------------------------------------------------------- phases
    def load_base(self):
        name = self.info.get('project')
        assert name, 'info.project is required'
        project = self.project_provider.by_name(name)
        if project is None:
            project = self.project_provider.add_project(name)
        self.project = project

    def create_report(self):
        layout_name = self.info.get('layout')
        if not layout_name:
            return
        layout = self.layout_provider.by_name(layout_name)
        assert layout is not None, f'unknown layout {layout_name!r}'
        resolved = self.layout_provider.resolved(layout_name)
        report = Report(
            name=self.info.get('name', 'report'),
            project=self.project.id, time=now(),
            layout=layout_name, config=yaml_dump(resolved))
        self.report_provider.add(report)
        self.dag_report_id = report.id

    def create_dag(self):
        dag = Dag(
            name=self.info.get('name', 'dag'),
            config=self.config_text or yaml_dump(dict(self.config)),
            project=self.project.id,
            docker_img=self.info.get('docker_img')
            or self.info.get('runtime_img'),
            type=int(DagType.Standard),
            created=now(),
            report=self.dag_report_id,
            # tenant label for the usage ledger (migration v14):
            # info.owner from the config or --owner on submit; every
            # task inherits it below so the supervisor's fold never
            # joins back to the dag row
            owner=str(self.info.get('owner') or 'default'),
            # scheduling class (migration v15): info.priority from the
            # config or --priority on submit, validated here so a typo
            # rejects the submission instead of silently reading as
            # the class default at dispatch
            priority=normalize_priority(self.info.get('priority')),
        )
        self.dag_provider.add(dag)
        self.dag = dag

    def upload(self):
        expdir = self.info.get('expdir')
        folder = self.upload_folder or expdir
        if folder and os.path.isdir(folder):
            self.storage.upload(folder, self.dag)

    def create_tasks(self):
        executors = self.config.get('executors', {})
        # dependency validation (reference standard.py:183-205)
        for name, spec in executors.items():
            depends = spec.get('depends') or []
            if isinstance(depends, str):
                depends = [depends]
            for dep in depends:
                if dep == name:
                    raise ValueError(f'executor {name!r} depends on itself')
                if dep not in executors:
                    raise ValueError(
                        f'executor {name!r} depends on unknown {dep!r}')

        created = {}  # name -> [Task]
        pending = dict(executors)
        while pending:
            progressed = False
            for name in list(pending):
                spec = pending[name]
                depends = spec.get('depends') or []
                if isinstance(depends, str):
                    depends = [depends]
                if any(d in pending for d in depends):
                    continue
                created[name] = self._create_executor_tasks(
                    name, spec, depends, created)
                del pending[name]
                progressed = True
            if not progressed:
                raise ValueError(
                    f'dependency cycle among executors: {sorted(pending)}')
        self.tasks = {
            name: [t.id for t in tasks] for name, tasks in created.items()
        }

    def _create_executor_tasks(self, name, spec, depends, created):
        grid = spec.get('grid')
        cells = grid_cells(grid) if grid else [(None, None)]
        sweep_info = None
        if spec.get('sweep') is not None:
            sweep_info = self._create_sweep(name, spec, grid, len(cells))
        tasks = []
        for cell_index, (cell, cell_name_str) in enumerate(cells):
            task = self._create_task(
                name, spec, cell, cell_name_str, cell_index,
                sweep_info=sweep_info)
            for dep in depends:
                for dep_task in created[dep]:
                    self.task_provider.add_dependency(task.id, dep_task.id)
            tasks.append(task)
        return tasks

    def _create_sweep(self, name, spec, grid, n_cells) -> dict:
        """The ``sweep`` row of a grid executor's ``sweep:`` block and
        the spec its cells carry in ``additional_info['sweep']`` (the
        trainer reports rung scores and checkpoints at rung boundaries
        from it). Validated here, so a bad block rejects the
        submission instead of a sweep that never prunes."""
        from mlcomp_tpu_torch.contrib.search.asha import (
            normalize_sweep_spec,
        )
        from mlcomp_tpu_torch.server.sweep import create_sweep
        if not grid:
            raise ValueError(
                f'executor {name!r}: sweep requires a grid (a '
                f'sweep schedules grid cells)')
        norm = normalize_sweep_spec(spec['sweep'])
        # cross-check against the trainer's score contract: cells
        # report main_metric under minimize's direction; a mismatch
        # would judge another series, or prune the winners
        if Executor.is_trainable(spec.get('type', name)):
            # resolved as Executor._parse_config does: the params:
            # block feeds constructor kwargs too, top-level keys win
            params = dict(spec.get('params') or {})
            resolved = {**params,
                        **{k: v for k, v in spec.items() if k != 'params'}}
            main_metric = resolved.get('main_metric', 'accuracy')
            if norm['metric'] != main_metric:
                raise ValueError(
                    f'executor {name!r}: sweep.metric '
                    f'{norm["metric"]!r} != the trainer\'s '
                    f'main_metric {main_metric!r} — cells report '
                    f'main_metric, so the sweep would judge a '
                    f'different series than the spec names')
            minimize = bool(resolved.get('minimize', False))
            if (norm['mode'] == 'min') != minimize:
                raise ValueError(
                    f'executor {name!r}: sweep.mode '
                    f'{norm["mode"]!r} contradicts the trainer\'s '
                    f'minimize={minimize} — the sweep would prune '
                    f'the best cells')
        sweep = create_sweep(self.session, self.dag, name, norm, n_cells)
        return dict(norm, id=sweep.id)

    def _create_task(self, name, spec, cell, cell_name_str, cell_index,
                     sweep_info=None):
        cores, cores_max = parse_cores(
            spec.get('cores', spec.get('gpu', 0)))
        executor_type = spec.get('type', name)
        trainable = Executor.is_trainable(executor_type)
        task_name = name
        if cell_name_str:
            task_name = f'{name} {cell_name_str}'
            if len(task_name) > 180:
                # truncate the CELL part, keeping its tail (grid.py
                # puts the disambiguating hash suffix at the end) AND
                # the executor-name prefix — two executors sharing a
                # big cell must not collapse to the same tail, which
                # is the cross-executor flavor of the collision the
                # hash fixed within one grid. A pathologically long
                # executor name is itself truncated first so the cell
                # tail (and its hash) ALWAYS survives the 180 cap.
                prefix = name if len(name) <= 120 else name[:119] + '…'
                cell_budget = 180 - len(prefix) - 2
                task_name = (f'{prefix} …'
                             f'{cell_name_str[-cell_budget:]}')

        additional_info = {'trace_id': self.trace_id}
        if cell is not None:
            additional_info['grid_cell'] = cell_index
            additional_info['grid'] = cell
        if sweep_info is not None:
            additional_info['sweep'] = dict(sweep_info)
        if spec.get('env'):
            additional_info['env'] = spec['env']
        if self.info.get('stages'):
            additional_info['stages'] = self.info['stages']
        # scheduler hints for distributed placement
        # (reference supervisor.py:228-313 reads `distr`/`single_node`)
        if 'distr' in spec:
            additional_info['distr'] = bool(spec['distr'])
        if spec.get('mesh') is not None:
            # fail a bad mesh/cores combination at SUBMISSION, not hours
            # later at executor mesh build (axis names, -1 rules,
            # product-vs-cores, tp/sp/ep multi-host pinning)
            from mlcomp_tpu_torch.parallel.meshspec import (
                validate_mesh_request,
            )
            validate_mesh_request(          # non-dict rejected inside
                spec['mesh'], cores, cores_max,
                single_node=bool(spec.get('single_node', True)))
            additional_info['mesh'] = spec['mesh']

        task = Task(
            name=task_name[:180],
            executor=name,
            computer=spec.get('computer'),
            cores=cores, cores_max=cores_max,
            cpu=int(spec.get('cpu', 1)),
            memory=float(spec.get('memory', 0.1)),
            dag=self.dag.id,
            status=int(TaskStatus.NotRan),
            type=int(TaskType.Train if trainable else TaskType.User),
            debug=self.debug,
            gpu_requirement=str(spec.get('cores', spec.get('gpu', '')) or ''),
            single_node=bool(spec.get('single_node', True)),
            additional_info=yaml_dump(additional_info),
            last_activity=now(),
            owner=str(self.info.get('owner') or 'default'),
            project=self.project.name,
            # per-executor spec overrides the dag-wide class; NULL
            # falls through to the class-based default at dispatch
            priority=normalize_priority(
                spec.get('priority'),
                default=normalize_priority(self.info.get('priority'))),
        )
        self.task_provider.add(task)

        if trainable:
            layout_name = spec.get('report') or self.info.get('layout')
            if layout_name and self.layout_provider.by_name(layout_name):
                resolved = self.layout_provider.resolved(layout_name)
                report = Report(
                    name=task_name[:100], project=self.project.id,
                    time=now(), layout=layout_name,
                    config=yaml_dump(resolved))
                self.report_provider.add(report)
                task.report = report.id
                self.task_provider.update(task, ['report'])
                if self.dag_report_id:
                    self.report_tasks_provider.add(ReportTasks(
                        report=self.dag_report_id, task=task.id))
                self.report_tasks_provider.add(ReportTasks(
                    report=report.id, task=task.id))
        return task

    # ----------------------------------------------------------- preflight
    def run_preflight(self):
        """Static analysis BEFORE any DB write: errors reject the
        submission (PreflightError), warnings are kept and stored with
        the dag row once it exists (store_preflight_warnings). Same
        gate_config policy the CLI submit path applies."""
        from mlcomp_tpu_torch.analysis import folder_sources, gate_config
        sources = folder_sources(self.upload_folder) \
            if self.upload_folder else None
        self.preflight_warnings = self.preflight_warnings + gate_config(
            self.config, sources=sources, params=self.preflight_params)

    def store_preflight_warnings(self):
        if not self.preflight_warnings:
            return
        from mlcomp_tpu_torch.db.providers import DagPreflightProvider
        DagPreflightProvider(self.session).add_findings(
            self.dag.id, self.preflight_warnings, source='submit')

    # --------------------------------------------------------------- build
    def build(self):
        if self.preflight:
            self.run_preflight()
        self.load_base()
        self.create_report()
        self.create_dag()
        self.store_preflight_warnings()   # no-op when nothing gated
        self.upload()
        self.create_tasks()
        return self.dag, self.tasks


def dag_standard(session, config: dict, debug: bool = False,
                 config_text: str = None, upload_folder: str = None,
                 logger=None, component=None, preflight: bool = False,
                 preflight_params: dict = None, preflight_warnings=None):
    builder = DagStandardBuilder(
        session, config, debug=debug, config_text=config_text,
        upload_folder=upload_folder, logger=logger, component=component,
        preflight=preflight, preflight_params=preflight_params,
        preflight_warnings=preflight_warnings)
    return builder.build()


__all__ = ['dag_standard', 'DagStandardBuilder', 'PreflightError',
           'parse_cores']

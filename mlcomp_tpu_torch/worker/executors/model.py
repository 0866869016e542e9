"""ModelAdd executor — port of ``mlcomp_tpu/worker/executors/model.py``.

Registers a trained model: the train task's checkpoint (the ``file``
under its checkpoint folder, else ``best``, else ``last``) is exported
into ``MODEL_FOLDER/<project>/<name>`` with ``train/export.py``
``export_from_checkpoint`` (the JAX layout, which either package's
predictor loads), and the Model row is written with the task's score,
or the row of that name updated. It differs from JAX's in one place:
the model spec of a grid cell's task is the cell's
(``_train_model_spec``).
"""

import os

from mlcomp_tpu_torch.utils.config import merge_dicts_smart
from mlcomp_tpu_torch.utils.io import yaml_load
from mlcomp_tpu_torch.worker.executors.base.executor import Executor


@Executor.register
class ModelAdd(Executor):
    def __init__(self, name: str, project: int = None,
                 train_task: int = None, file: str = None,
                 equations: str = '', **kwargs):
        self.name = name
        self.project = project
        self.train_task = train_task
        self.file = file
        self.equations = equations

    @classmethod
    def _parse_config(cls, executor_spec, config, additional_info):
        kwargs = super()._parse_config(executor_spec, config,
                                       additional_info)
        kwargs.setdefault('train_task', kwargs.pop('task', None))
        return kwargs

    def _train_model_spec(self, task):
        """The model spec the train task ran with, which the export
        needs to rebuild the model: its executor's in the DAG config,
        with the task's grid cell merged in as the trainer merges it.
        (JAX's ``ModelAdd`` reads the executor's spec alone, so a grid
        cell that changes the model, ``model/name: vit`` of
        ``examples/encoder_grid``, is exported under the base spec and
        does not load.)"""
        from mlcomp_tpu_torch.db.providers import DagProvider
        dag = DagProvider(self.session).by_id(task.dag)
        config = yaml_load(dag.config) if dag and dag.config else {}
        executor = dict(config.get('executors', {}).get(task.executor, {}))
        info = yaml_load(task.additional_info) \
            if task.additional_info else {}
        cell = (info or {}).get('grid')
        if cell and executor:
            executor = merge_dicts_smart(executor, dict(cell))
        spec = executor.get('model')
        return dict(spec) if spec else None

    def work(self):
        from mlcomp_tpu_torch import MODEL_FOLDER, TASK_FOLDER
        from mlcomp_tpu_torch.db.models import Model
        from mlcomp_tpu_torch.db.providers import (
            ModelProvider, ProjectProvider, TaskProvider,
        )
        from mlcomp_tpu_torch.train.checkpoint import checkpoint_exists
        from mlcomp_tpu_torch.utils.misc import now

        project_id = self.project if self.project is not None \
            else (self.dag.project if self.dag else None)
        model = Model(name=self.name, project=project_id,
                      equations=self.equations or '', created=now())
        provider = ModelProvider(self.session)

        if self.train_task:
            task = TaskProvider(self.session).by_id(self.train_task)
            if task is None:
                raise ValueError(f'train task {self.train_task} not found')
            model.score_local = task.score
            model.dag = task.dag

            # a distributed job's ranks write to the parent's folder
            ck_dir = os.path.join(TASK_FOLDER, str(task.parent or task.id),
                                  'checkpoints')
            src = self.file and os.path.join(ck_dir, self.file)
            if not src or not os.path.exists(src):
                src = checkpoint_exists(ck_dir, 'best') \
                    or checkpoint_exists(ck_dir, 'last')
            if not src:
                raise FileNotFoundError(
                    f'no checkpoint under {ck_dir!r} to register')

            spec = self._train_model_spec(task)
            if not spec:
                raise ValueError(
                    f'train task {task.id} has no model spec in its '
                    f'dag config — cannot build a loadable export')
            project = ProjectProvider(self.session).by_id(project_id)
            folder = os.path.join(
                MODEL_FOLDER, project.name if project else 'default')
            from mlcomp_tpu_torch.train.export import export_from_checkpoint
            out = export_from_checkpoint(
                src, spec, os.path.join(folder, self.name),
                meta={'score': task.score})
            self.info(f'registered model {self.name!r} from task '
                      f'{task.id} -> {out}')

        existing = provider.by_name(self.name)
        if existing is not None:
            for field in ('score_local', 'dag', 'project', 'equations'):
                value = getattr(model, field)
                if value is not None and value != '':
                    setattr(existing, field, value)
            provider.update(existing)
            return {'model': existing.id}
        provider.add(model)
        return {'model': model.id}


__all__ = ['ModelAdd']

"""Model-start DAG builder — port of
``mlcomp_tpu/server/create_dags/model_start.py``.

Starts a registered pipe for a model: the pipe's executor specs come
out of the Pipe DAG's config, the chosen equations version is laid over
them (over the one executor, or per key), the version is marked
``used`` in ``model.equations``, ``model_id`` / ``model_name`` are
stamped into every executor, and the result is submitted as a standard
DAG.
"""

from mlcomp_tpu_torch.db.providers import (
    DagProvider, ModelProvider, ProjectProvider,
)
from mlcomp_tpu_torch.server.create_dags.standard import dag_standard
from mlcomp_tpu_torch.utils.io import yaml_dump, yaml_load
from mlcomp_tpu_torch.utils.misc import now


def dag_model_start(session, data: dict):
    model_provider = ModelProvider(session)
    model = model_provider.by_id(int(data['model_id']))
    if model is None:
        raise ValueError(f"model {data['model_id']} not found")
    dag_provider = DagProvider(session)
    pipe_dag = dag_provider.by_id(int(data['dag']))
    if pipe_dag is None:
        raise ValueError(f"dag {data['dag']} not found")
    project = ProjectProvider(session).by_id(pipe_dag.project)

    src_config = yaml_load(pipe_dag.config)
    pipe_info = data['pipe']
    pipe_name = pipe_info['name']
    pipes = src_config.get('pipes') or {}
    if pipe_name not in pipes:
        raise ValueError(f'pipe {pipe_name!r} not in dag {pipe_dag.id}')
    pipe = {k: dict(v) for k, v in pipes[pipe_name].items()}

    equations = yaml_load(model.equations) if model.equations else {}
    versions = list(pipe_info.get('versions') or [])
    if versions:
        chosen = pipe_info.get('version') or versions[0]
        overlay = chosen.get('equations') or {}
        if isinstance(overlay, str):
            overlay = yaml_load(overlay) or {}
        for v in versions:
            if v.get('name') == chosen.get('name'):
                v['used'] = str(now())
        if len(pipe) == 1:
            pipe[next(iter(pipe))].update(overlay)
        else:
            for key in overlay:
                if key in pipe and isinstance(overlay[key], dict):
                    pipe[key].update(overlay[key])
    equations[pipe_name] = versions
    model.equations = yaml_dump(equations)

    for spec in pipe.values():
        spec['model_id'] = model.id
        spec['model_name'] = model.name

    if not model.dag:
        model.dag = pipe_dag.id
    model_provider.update(model)

    config = {
        'info': {'name': pipe_name, 'project': project.name},
        'executors': pipe,
    }
    dag, _tasks = dag_standard(session, config)
    return dag


__all__ = ['dag_model_start']

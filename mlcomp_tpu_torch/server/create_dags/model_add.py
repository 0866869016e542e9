"""Model-add DAG builder — port of
``mlcomp_tpu/server/create_dags/model_add.py``.

With no source task it writes the Model row alone. With a train task it
builds a one-executor DAG that runs ``ModelAdd`` on the computer that
holds the task's checkpoint (a child's computer, for a distributed job
whose ranks all write to the parent's folder).
"""

from mlcomp_tpu_torch.db.models import Model
from mlcomp_tpu_torch.db.providers import (
    DagProvider, ModelProvider, ProjectProvider, TaskProvider,
)
from mlcomp_tpu_torch.server.create_dags.standard import dag_standard
from mlcomp_tpu_torch.utils.misc import now


def dag_model_add(session, data: dict):
    if not data.get('task'):
        model = Model(
            name=data['name'], project=data['project'],
            equations=data.get('equations', ''), created=now())
        ModelProvider(session).add(model)
        return None

    task_provider = TaskProvider(session)
    task = task_provider.by_id(int(data['task']))
    if task is None:
        raise ValueError(f"task {data['task']} not found")
    children = task_provider.children(task.id)
    computer = children[0].computer_assigned if children \
        else task.computer_assigned

    project_id = data.get('project')
    if project_id is None:
        project_id = DagProvider(session).by_id(task.dag).project
    project = ProjectProvider(session).by_id(project_id)
    config = {
        'info': {
            'name': 'model_add',
            'project': project.name,
        },
        'executors': {
            'model_add': {
                'type': 'model_add',
                'computer': computer,
                'project': project.id,
                'task': int(data['task']),
                'name': data['name'],
                'file': data.get('file'),
            },
        },
    }
    dag, _tasks = dag_standard(session, config)
    return dag


__all__ = ['dag_model_add']

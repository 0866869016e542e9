"""Pipe DAG builder — port of ``mlcomp_tpu/server/create_dags/pipe.py``.

A ``pipes:`` config registers named serving pipelines (dicts of
Equation-executor specs) as a ``DagType.Pipe`` row. Nothing runs at
registration: ``dag_model_start`` later starts a pipe for a registered
model. Models already named after a pipe of the config, or after the
dag, are re-pointed at the new registration.
"""

from mlcomp_tpu_torch.db.enums import DagType
from mlcomp_tpu_torch.db.models import Dag
from mlcomp_tpu_torch.db.providers import DagProvider, ProjectProvider
from mlcomp_tpu_torch.utils.io import yaml_dump
from mlcomp_tpu_torch.utils.misc import now
from mlcomp_tpu_torch.worker.storage import Storage


def dag_pipe(session, config: dict, config_text: str = None,
             upload_folder: str = None, logger=None):
    assert 'pipes' in config, 'config needs a pipes: section'
    info = config.get('info', {})

    project_provider = ProjectProvider(session)
    project = project_provider.by_name(info['project'])
    if project is None:
        project = project_provider.add_project(info['project'])

    dag = Dag(
        name=info.get('name', 'pipe'),
        config=config_text or yaml_dump(dict(config)),
        project=project.id,
        docker_img=info.get('docker_img') or info.get('runtime_img'),
        type=int(DagType.Pipe),
        created=now(),
    )
    DagProvider(session).add(dag)

    if upload_folder:
        Storage(session, logger).upload(upload_folder, dag)

    names = set(config['pipes']) | {info.get('name')}
    for name in filter(None, names):
        session.execute(
            'UPDATE model SET dag=? WHERE project=? AND name=?',
            (dag.id, project.id, name))
    return dag


__all__ = ['dag_pipe']

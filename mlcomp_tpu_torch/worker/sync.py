"""Data and model movement between computers (port of
``mlcomp_tpu/worker/sync.py``).

The TaskSynced ledger drives it: a computer pulls the project folders
of successful tasks that ran elsewhere, then marks them synced, which
releases the executors' ``wait_data_sync`` barrier. On shared storage
(the usual deployment) source and destination are the same files and
the copy is a no-op; an ``rsync`` over ``ssh`` covers disjoint hosts
where both binaries exist.
"""

import os
import shutil
import subprocess

from mlcomp_tpu_torch import DATA_FOLDER, MODEL_FOLDER
from mlcomp_tpu_torch.db.core import Session
from mlcomp_tpu_torch.db.providers import (
    ComputerProvider, ProjectProvider, TaskSyncedProvider,
)
from mlcomp_tpu_torch.utils.misc import hostname, now


def _rsync_available() -> bool:
    return shutil.which('rsync') is not None and \
        shutil.which('ssh') is not None


def sync_directed(session: Session, source, target, folders=None) -> bool:
    """Pull ``folders`` (default: data and models) from the source
    computer to the target. True when the data is known to be present
    (shared storage: trivially); a failed rsync returns False, so
    callers must not mark tasks synced."""
    src_name = source if isinstance(source, str) else source.name
    tgt_name = target if isinstance(target, str) else target.name
    if src_name == tgt_name:
        return True
    folders = folders or [DATA_FOLDER, MODEL_FOLDER]
    if not _rsync_available():
        return True             # shared-storage deployment
    src = ComputerProvider(session).by_name(src_name)
    if src is None:
        return False
    dest = f'{src.user}@{src.ip}' if src.user else src.ip
    ok = True
    for folder in folders:
        code = subprocess.call([
            'rsync', '-a', '-e', f'ssh -p {src.port}',
            f'{dest}:{folder}/', f'{folder}/'])
        ok = ok and code == 0
    return ok


class FileSync:
    """The sync pass the worker-supervisor schedules: pull what
    successful tasks on other computers produced, then mark them synced
    in the TaskSynced ledger."""

    def __init__(self, session: Session = None):
        self.session = session or Session.create_session(key='sync')
        self.hostname = hostname()

    def sync(self):
        provider = TaskSyncedProvider(self.session)
        computer_provider = ComputerProvider(self.session)
        project_provider = ProjectProvider(self.session)
        me = computer_provider.by_name(self.hostname)
        if me is not None and not me.sync_with_this_computer:
            return 0
        synced = 0
        for source, project_id, tasks in provider.for_computer(
                self.hostname):
            project = project_provider.by_id(project_id)
            folders = []
            if project is not None:
                folders = [os.path.join(DATA_FOLDER, project.name),
                           os.path.join(MODEL_FOLDER, project.name)]
            if not sync_directed(self.session, source, self.hostname,
                                 folders):
                continue        # a failed transfer keeps the barrier
            for task in tasks:
                provider.mark_synced(self.hostname, task.id)
                synced += 1
        if me is not None:
            me.last_synced = now()
            computer_provider.update(me, ['last_synced'])
        return synced


__all__ = ['FileSync', 'sync_directed']

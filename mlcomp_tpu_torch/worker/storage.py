"""Code-in-DB content store (port of ``mlcomp_tpu/worker/storage.py``).

- ``upload``: walk an experiment folder, honour ``.ignore`` glob patterns,
  md5-dedup file blobs into the ``file`` table, map paths via
  ``dag_storage``, record imported library versions via ``dag_library``
- ``download``: materialize a DAG's code into ``TASK_FOLDER/<task_id>`` and
  symlink the project's ``data/`` and ``models/`` folders
- ``import_executor``: find and import the module in the unpacked folder
  (or the port's builtin executor package) defining the executor class
  whose snake-case name matches. A folder whose code imports the JAX
  package cannot run in the port: that import fails with its own error.

The JAX package hashes the tree in a threaded C++ pass; here it is
``hashlib.md5`` per file, the same digests.
"""

import ast
import fnmatch
import hashlib
import importlib
import importlib.util
import os
import sys

from mlcomp_tpu_torch import DATA_FOLDER, MODEL_FOLDER, TASK_FOLDER
from mlcomp_tpu_torch.db.models import Dag, DagLibrary, DagStorage, File
from mlcomp_tpu_torch.db.providers import (
    DagLibraryProvider, DagStorageProvider, FileProvider
)
from mlcomp_tpu_torch.utils.misc import now, to_snake
from mlcomp_tpu_torch.utils.req import control_requirements


def link_project_folders(folder: str, project_name: str):
    """Symlink ``<folder>/data`` and ``<folder>/models`` at the project's
    shared folders. Repairs broken/stale links (a link left behind by a
    renamed project is re-pointed); a real user-owned directory at the
    link path is left untouched."""
    for name, base in (('data', DATA_FOLDER), ('models', MODEL_FOLDER)):
        target = os.path.join(base, project_name)
        os.makedirs(target, exist_ok=True)
        link = os.path.join(folder, name)
        if os.path.islink(link):
            if os.readlink(link) == target:
                continue
            os.remove(link)
        elif os.path.lexists(link):
            continue
        os.symlink(target, link, target_is_directory=True)


def _load_ignore(folder: str, extra: list = None):
    patterns = list(extra or [])
    ignore_file = os.path.join(folder, '.ignore')
    if os.path.exists(ignore_file):
        with open(ignore_file) as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith('#'):
                    patterns.append(line)
    return patterns


def _md5_file(path: str):
    """md5 hex digest of a file's bytes, None when it cannot be read."""
    try:
        with open(path, 'rb') as fh:
            return hashlib.md5(fh.read()).hexdigest()
    except OSError:
        return None


def _ignored(rel: str, patterns) -> bool:
    parts = rel.split(os.sep)
    for pat in patterns:
        if fnmatch.fnmatch(rel, pat) or fnmatch.fnmatch(parts[-1], pat):
            return True
        if any(fnmatch.fnmatch(p, pat.rstrip('/')) for p in parts[:-1]):
            return True
    return False


class Storage:
    def __init__(self, session, logger=None, component=None):
        self.session = session
        self.logger = logger
        self.component = component
        self.file_provider = FileProvider(session)
        self.storage_provider = DagStorageProvider(session)
        self.library_provider = DagLibraryProvider(session)

    # ---------------------------------------------------------------- upload
    def upload(self, folder: str, dag: Dag, control_reqs: bool = True):
        """Upload folder contents into the DB under `dag`. Returns stats."""
        # data/models/log are runtime folders — never blobbed into the DB
        # (reference worker/storage.py appends the same defaults)
        patterns = _load_ignore(folder, extra=[
            '__pycache__', '*.pyc', '.git', '.idea', 'log', 'logs',
            'data', 'models'])
        hashs = self.file_provider.hashs(dag.project)
        files_size = 0
        count = 0
        uploads = []  # (rel, full) pending files
        for root, dirs, files in os.walk(folder):
            rel_root = os.path.relpath(root, folder)
            dirs[:] = [
                d for d in dirs
                if not _ignored(os.path.normpath(os.path.join(rel_root, d)),
                                patterns)
            ]
            if rel_root != '.':
                self.storage_provider.add(DagStorage(
                    dag=dag.id, path=os.path.normpath(rel_root),
                    is_dir=True))
            for f in files:
                rel = os.path.normpath(os.path.join(rel_root, f))
                if _ignored(rel, patterns):
                    continue
                uploads.append((rel, os.path.join(root, f)))

        # hash the whole tree first so dedup hits skip the re-read; with
        # no prior blobs every probe would miss, so skip the pass
        def _sig(path):
            try:
                st = os.stat(path)
                return st.st_size, st.st_mtime_ns
            except OSError:
                return None
        # sigs BEFORE the hash pass: a file changed during hashing then
        # fails the sig-now comparison and falls to the re-read branch
        sigs = [_sig(full) for _, full in uploads]
        digests = [_md5_file(full) for _, full in uploads] \
            if hashs else [None] * len(uploads)
        for (rel, full), probe, sig in zip(uploads, digests, sigs):
            # a dedup hit is only trusted if the file is provably the one
            # the probe pass hashed (same size+mtime now). If a same-size
            # rewrite slips inside one mtime tick, this links the blob the
            # probe actually read — an internally consistent snapshot a
            # few ms stale, not a digest/content mismatch (uploading a
            # mutating tree is inherently a racy snapshot)
            if probe is not None and probe in hashs \
                    and sig is not None and _sig(full) == sig:
                file_id = hashs[probe]
            else:
                with open(full, 'rb') as fh:
                    content = fh.read()
                # always digest the bytes actually read: trusting the
                # probe digest on an unchanged (size, mtime) signature is
                # a TOCTOU on coarse-mtime filesystems — a same-size
                # rewrite between the hash pass and this read would store
                # new content under the stale digest
                md5 = hashlib.md5(content).hexdigest()
                if md5 in hashs:
                    file_id = hashs[md5]
                else:
                    file = File(
                        md5=md5, content=content, project=dag.project,
                        dag=dag.id, created=now(), size=len(content))
                    self.file_provider.add(file)
                    hashs[md5] = file.id
                    file_id = file.id
                    files_size += len(content)
            self.storage_provider.add(DagStorage(
                dag=dag.id, path=rel, file=file_id, is_dir=False))
            count += 1

        if control_reqs:
            for lib, version in control_requirements(
                    folder, write_file=False):
                self.library_provider.add(DagLibrary(
                    dag=dag.id, library=lib, version=version))

        dag.file_size = files_size
        self.session.update_obj(dag, ['file_size'])
        return {'count': count, 'size': files_size}

    # -------------------------------------------------------------- download
    def download(self, task: int, dag: Dag = None) -> str:
        """Materialize DAG code to TASK_FOLDER/<task>; symlink data/models."""
        folder = os.path.join(TASK_FOLDER, str(task))
        os.makedirs(folder, exist_ok=True)
        if dag is None:
            from mlcomp_tpu_torch.db.providers import TaskProvider, DagProvider
            t = TaskProvider(self.session).by_id(task)
            dag = DagProvider(self.session).by_id(t.dag)
        items = self.storage_provider.by_dag(dag.id)
        for storage, content in items:
            path = os.path.join(folder, storage.path)
            if storage.is_dir:
                os.makedirs(path, exist_ok=True)
            else:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, 'wb') as fh:
                    fh.write(content if content is not None else b'')

        from mlcomp_tpu_torch.db.providers import ProjectProvider
        project = ProjectProvider(self.session).by_id(dag.project)
        link_project_folders(folder, project.name if project else 'default')
        return folder

    # ------------------------------------------------------------ libraries
    def install_libraries(self, dag_id: int) -> list:
        """The DagLibrary-recorded versions that differ from the running
        environment, as ``lib==version`` specs. The JAX package pip-
        installs them; the card's machine has no network, so where one
        is missing this raises instead. Only called when
        INSTALL_LIBRARIES is enabled (opt-in)."""
        from importlib import metadata
        needed = []
        for library, version in self.library_provider.dag(dag_id):
            if not version:
                continue
            try:
                have = metadata.version(library)
            except metadata.PackageNotFoundError:
                have = None
            if have != version:
                needed.append(f'{library}=={version}')
        if needed:
            raise RuntimeError(
                f'INSTALL_LIBRARIES: {" ".join(needed)} differ from this '
                f'environment, and the port installs nothing (no network '
                f'on the card\'s machine); install them first or unset '
                f'INSTALL_LIBRARIES')
        return needed

    # ------------------------------------------------------------- importing
    def import_executor(self, folder: str, executor_type: str):
        """Find and import the executor class for `executor_type`.

        Scan order (reference worker/storage.py:185-239): built-in executor
        package first, then the task folder's modules. Matching rule: a
        class whose name or snake_case name equals `executor_type`.
        """
        from mlcomp_tpu_torch.worker.executors import Executor
        # builtin import registers all framework executors
        importlib.import_module('mlcomp_tpu_torch.worker.executors')
        if Executor.is_registered(executor_type):
            return Executor.get(executor_type)

        candidates = self._scan_folder(folder, executor_type)
        for module_path in candidates:
            name = 'user_code_' + hashlib.md5(
                module_path.encode()).hexdigest()[:10]
            spec = importlib.util.spec_from_file_location(name, module_path)
            module = importlib.util.module_from_spec(spec)
            sys.path.insert(0, folder)
            try:
                sys.modules[name] = module
                spec.loader.exec_module(module)
            finally:
                sys.path.remove(folder)
            if Executor.is_registered(executor_type):
                return Executor.get(executor_type)
            # the class may exist without the decorator — register manually
            for attr in vars(module).values():
                if isinstance(attr, type) and issubclass(attr, Executor) \
                        and attr is not Executor \
                        and to_snake(attr.__name__) == to_snake(
                            executor_type):
                    Executor.register(attr)
                    return attr
        raise ModuleNotFoundError(
            f'executor {executor_type!r} not found in builtin executors '
            f'or {folder}')

    @staticmethod
    def _scan_folder(folder: str, executor_type: str):
        """Paths of modules whose AST contains a matching class def."""
        want = to_snake(executor_type)
        out = []
        for root, dirs, files in os.walk(folder):
            dirs[:] = [d for d in dirs if not d.startswith('.')
                       and d != '__pycache__']
            for f in files:
                if not f.endswith('.py'):
                    continue
                path = os.path.join(root, f)
                try:
                    with open(path, encoding='utf-8',
                              errors='ignore') as fh:
                        tree = ast.parse(fh.read())
                except SyntaxError:
                    continue
                for node in ast.walk(tree):
                    if isinstance(node, ast.ClassDef) \
                            and to_snake(node.name) == want:
                        out.append(path)
                        break
        return out


__all__ = ['Storage']

"""The port's import boundary: ``mlcomp_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax, optax, the JAX package ``mlcomp_tpu``, or
of ``click``, ``msgpack``, pandas, OpenCV, PyYAML and ``psutil`` (which
the card's machine does not have) — and serving really runs with all of those
unimportable."""

import ast
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'mlcomp_tpu', 'click',
             'msgpack', 'pandas', 'cv2', 'yaml', 'psutil')


def _port_files():
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(os.path.join(REPO, 'mlcomp_tpu_torch')):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return sorted(out)


def forbidden_imports(source: str) -> list:
    """(line, module) of every import whose top-level package is one of
    FORBIDDEN (``mlcomp_tpu_torch`` itself is of course allowed)."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or '']
        else:
            continue
        hits += [(node.lineno, n) for n in names
                 if n.split('.')[0] in FORBIDDEN]
    return hits


def test_port_files_exist():
    files = [os.path.relpath(f, REPO) for f in _port_files()]
    assert 'chip_smoke.py' in files
    assert 'mlcomp_tpu_torch/server/serve.py' in files
    assert {'mlcomp_tpu_torch/server/sweep.py',
            'mlcomp_tpu_torch/db/providers/sweep.py',
            'mlcomp_tpu_torch/contrib/search/asha.py',
            'mlcomp_tpu_torch/worker/executors/sweep_probe.py',
            'mlcomp_tpu_torch/db/providers/usage.py',
            'mlcomp_tpu_torch/db/providers/quota.py',
            'mlcomp_tpu_torch/telemetry/watchdog.py',
            'mlcomp_tpu_torch/telemetry/slo.py'} <= set(files)
    assert len(files) > 15


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path) as fh:
        hits = forbidden_imports(fh.read())
    assert not hits, f'{os.path.relpath(path, REPO)} imports {hits}'


#: modules of the control plane that run in processes holding no CUDA
#: context (the gateway; the site's fleet reconciler, ASHA sweep
#: scheduler, scheduling policy, quota admission, preemption audit,
#: usage ledger, watchdog and SLO engine; the synthetic sweep cell; the
#: contrib command's fold files and the registry's DAG builders): they
#: must not import torch, even inside a function
TORCH_FREE = ('mlcomp_tpu_torch/server/gateway.py',
              'mlcomp_tpu_torch/server/fleet.py',
              'mlcomp_tpu_torch/db/providers/fleet.py',
              'mlcomp_tpu_torch/server/sweep.py',
              'mlcomp_tpu_torch/db/providers/sweep.py',
              'mlcomp_tpu_torch/contrib/search/asha.py',
              'mlcomp_tpu_torch/worker/executors/sweep_probe.py',
              'mlcomp_tpu_torch/server/scheduler.py',
              'mlcomp_tpu_torch/db/providers/quota.py',
              'mlcomp_tpu_torch/db/providers/usage.py',
              'mlcomp_tpu_torch/telemetry/watchdog.py',
              'mlcomp_tpu_torch/telemetry/slo.py',
              'mlcomp_tpu_torch/contrib/__main__.py',
              'mlcomp_tpu_torch/contrib/split/frame.py',
              'mlcomp_tpu_torch/utils/csv_io.py',
              'mlcomp_tpu_torch/utils/png.py',
              'mlcomp_tpu_torch/server/create_dags/pipe.py',
              'mlcomp_tpu_torch/server/create_dags/model_add.py',
              'mlcomp_tpu_torch/server/create_dags/model_start.py')


@pytest.mark.parametrize('path', TORCH_FREE)
def test_fleet_control_plane_imports_no_torch(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or '')
    assert names and not [n for n in names
                          if n.split('.')[0] == 'torch'], names


def test_checker_catches_each_form():
    src = textwrap.dedent('''
        import os, jax.numpy as jnp
        from flax import linen
        from mlcomp_tpu.ops import fused_attention
        import mlcomp_tpu_torch.ops
        from . import sibling
        def f():
            import msgpack
    ''')
    assert [m for _, m in forbidden_imports(src)] == [
        'jax.numpy', 'flax', 'mlcomp_tpu.ops', 'msgpack']


_BLOCKER = textwrap.dedent('''
    import importlib.abc, sys
    BLOCKED = {blocked!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f'{{name}} is blocked in this process')
            return None

    sys.meta_path.insert(0, Blocker())
    import runpy
    sys.argv = [{module!r}] + {argv!r}
    runpy.run_module({module!r}, run_name='__main__')
''')


def test_serving_on_cpu_without_jax(tmp_path):
    """``python -m mlcomp_tpu_torch.server serve`` in a subprocess where
    importing jax, flax, optax, mlcomp_tpu, click or msgpack raises:
    it serves a request, reports the CPU on /health and drains on
    SIGTERM with exit code 0."""
    from mlcomp_tpu_torch import TOKEN
    from mlcomp_tpu_torch.convert import params_to_jax
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.train.export import export_model
    spec = {'name': 'transformer_lm', 'vocab_size': 32, 'd_model': 16,
            'n_layers': 1, 'n_heads': 2, 'd_ff': 32, 'max_seq_len': 8,
            'dtype': 'float32'}
    model = create_model(**spec, device='cpu')
    path = export_model(str(tmp_path / 'lm'), params_to_jax(
        model.state_dict(), n_heads=2), spec,
        meta={'input_shape': [8], 'input_dtype': 'int32'})
    code = _BLOCKER.format(
        blocked=FORBIDDEN, module='mlcomp_tpu_torch.server', argv=[
            'serve', path, '--device', 'cpu', '--port', '0',
            '--batch-size', '2', '--activation', 'argmax'])
    env = {**os.environ, 'PYTHONPATH': REPO}
    proc = subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith('serving lm on http://'), \
            line + proc.stderr.read()
        port = int(line.split('http://127.0.0.1:')[1].split()[0])
        x = np.random.RandomState(0).randint(0, 32, (3, 8))
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/predict',
            data=json.dumps({'x': x.tolist()}).encode(),
            headers={'Authorization': TOKEN})
        with urllib.request.urlopen(req, timeout=60) as resp:
            y = np.asarray(json.loads(resp.read())['y'])
        with torch.no_grad():
            want = model(torch.from_numpy(x)).argmax(-1).numpy()
        np.testing.assert_array_equal(y, want)
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/health',
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health['platform'] == 'cpu' and health['requests'] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _cli_without_forbidden(argv, root):
    code = _BLOCKER.format(blocked=FORBIDDEN, module='mlcomp_tpu_torch',
                           argv=argv)
    env = {**os.environ, 'PYTHONPATH': REPO, 'MLCOMP_TPU_ROOT': str(root)}
    return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_runs_without_yaml_click_or_jax(tmp_path):
    """``python -m mlcomp_tpu_torch`` where importing PyYAML, click, jax
    or the JAX package raises: ``--help`` lists the four commands, and
    ``init``, ``check`` and ``execute`` of a small MLP on the CPU run to
    their end."""
    root = tmp_path / 'root'
    proc = _cli_without_forbidden(['--help'], root)
    assert proc.returncode == 0, proc.stderr
    for command in ('init', 'check', 'dag', 'execute'):
        assert command in proc.stdout
    folder = tmp_path / 'mlp'
    folder.mkdir()
    (folder / 'config.yml').write_text(textwrap.dedent('''\
        info: {name: mlp_cpu, project: mlp_cpu}
        executors:
          train:
            type: jax_train     # the port's train
            model: {name: mlp, num_classes: 10}
            dataset: {name: synthetic_images, n_train: 32, n_valid: 16,
                      image_size: 8, channels: 1, num_classes: 10}
            batch_size: 16
            device: cpu
            stages:
              - {name: s1, epochs: 1, optimizer: {name: adam, lr: 0.001}}
        '''))
    for argv in (['init'], ['check', str(folder / 'config.yml')],
                 ['execute', str(folder / 'config.yml')]):
        proc = _cli_without_forbidden(argv, root)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        'train': 'Success'}


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """Here there is no card; alone in a directory it also lacks the
    package. Either way it exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert 'FAIL' in proc.stdout

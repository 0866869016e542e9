"""Folds, fold files and submissions of the port against the JAX
package's: the three splitters bit for bit over hypothesis-drawn labels,
groups, fold counts and seeds; ``utils/csv_io`` against pandas' reading
and writing; the ``split`` executor's ``fold.csv`` in its four variants;
the four contrib commands (argparse) against JAX's click group run
through ``CliRunner``; ``submit_classify``'s csv. Files are compared
byte for byte."""

import contextlib
import csv
import io
import itertools
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner
from hypothesis import given, settings
from hypothesis import strategies as st

import mlcomp_tpu
from mlcomp_tpu.contrib import split as jax_split
from mlcomp_tpu.contrib.__main__ import main as jax_contrib
from mlcomp_tpu.utils.config import Config as JaxConfig
from mlcomp_tpu.worker.executors import Executor as JaxExecutor
import mlcomp_tpu_torch
from mlcomp_tpu_torch.contrib import split as port_split
from mlcomp_tpu_torch.contrib.__main__ import main as port_contrib
from mlcomp_tpu_torch.utils.config import Config
from mlcomp_tpu_torch.utils.csv_io import read_csv, write_csv
from mlcomp_tpu_torch.worker.executors import Executor

SPLITTERS = ('stratified_k_fold', 'group_k_fold', 'stratified_group_k_fold')


def _call(module, name, labels, groups, n_splits, seed):
    fn = getattr(module, name)
    if name == 'group_k_fold':
        return fn(groups, n_splits=n_splits, seed=seed)
    if name == 'stratified_group_k_fold':
        return fn(labels, groups=groups, n_splits=n_splits, seed=seed)
    return fn(labels, n_splits=n_splits, seed=seed)


@pytest.mark.parametrize('name', SPLITTERS)
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_splitters_are_jaxs_bit_for_bit(name, data):
    n = data.draw(st.integers(1, 60))
    labels = np.asarray(data.draw(st.lists(
        st.integers(0, 4), min_size=n, max_size=n)))
    if data.draw(st.booleans()):
        labels = np.asarray([f'c{v}' for v in labels], dtype=object)
    groups = np.asarray(data.draw(st.lists(
        st.integers(0, 9), min_size=n, max_size=n)))
    n_splits = data.draw(st.integers(2, 6))
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    got = _call(port_split, name, labels, groups, n_splits, seed)
    want = _call(jax_split, name, labels, groups, n_splits, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', SPLITTERS)
def test_columns_by_name_from_a_csv(tmp_path, name):
    """A label (and group) given by column name, read from the csv by
    each package's reader."""
    rng = np.random.RandomState(3)
    path = tmp_path / 'train.csv'
    pd.DataFrame({'label': rng.choice(['cat', 'dog', 'eel'], 40),
                  'group': rng.randint(0, 7, 40)}).to_csv(path, index=False)
    kw = {'file': str(path), 'n_splits': 4, 'seed': 5}
    if name == 'group_k_fold':
        args = ('group',)
    else:
        args = ('label',)
    if name == 'stratified_group_k_fold':
        kw['group_column'] = 'group'
    got = getattr(port_split, name)(*args, **kw)
    want = getattr(jax_split, name)(*args, **kw)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='df= or file='):
        getattr(port_split, name)('label')


# ------------------------------------------------------------ csv tables
_CELLS = st.one_of(
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(allow_nan=False, allow_infinity=False, width=32).map(repr),
    st.sampled_from(['', 'NA', 'nan', 'True', 'False', 'x', 'a b',
                     'q"q', 'c,d', ' 7']),
    st.text(alphabet='abcxyz', min_size=1, max_size=4))


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_csv_tables_read_and_write_as_pandas(tmp_path_factory, data):
    """Columns drawn from integers, floats, booleans, words and pandas'
    missing-value words: the same types and values as ``pd.read_csv``,
    and ``write_csv`` writes the bytes ``to_csv(index=False)`` writes of
    them with a ``fold`` column added."""
    folder = tmp_path_factory.mktemp('csv')
    n_cols = data.draw(st.integers(1, 4))
    n_rows = data.draw(st.integers(1, 8))
    kinds = [data.draw(st.sampled_from(['int', 'float', 'bool', 'any']))
             for _ in range(n_cols)]
    pools = {'int': st.integers(-99, 99).map(str),
             'float': st.one_of(st.floats(-1e3, 1e3, width=32).map(repr),
                                st.sampled_from(['', 'NA', '1'])),
             'bool': st.sampled_from(['True', 'False']), 'any': _CELLS}
    rows = [[data.draw(pools[k]) for k in kinds] for _ in range(n_rows)]
    path = folder / 'in.csv'
    with open(path, 'w', newline='') as fh:
        writer = csv.writer(fh, lineterminator='\n')
        writer.writerow([f'c{i}' for i in range(n_cols)])
        writer.writerows(rows)
    want = pd.read_csv(path)
    got = read_csv(str(path))
    assert list(got) == list(want.columns)
    for name in got:
        w = want[name]
        if pd.api.types.is_string_dtype(w.dtype) or w.dtype == object:
            assert got[name].dtype == object
            assert [None if isinstance(v, float) else v
                    for v in got[name]] == \
                [None if isinstance(v, float) else v for v in w.tolist()]
        else:
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w.to_numpy())
    fold = np.arange(n_rows) % 3
    got['fold'] = fold
    want['fold'] = fold
    write_csv(str(folder / 'port.csv'), got)
    want.to_csv(folder / 'jax.csv', index=False)
    assert (folder / 'port.csv').read_bytes() == \
        (folder / 'jax.csv').read_bytes()


#: cells whose typing is pandas' own: missing-value words, booleans,
#: numbers in every spelling the C reader takes, and words
CELLS = ['', 'NA', 'nan', 'None', 'True', 'False', 'true', 'x', '1', '-2',
         '1.5', '1e3', ' 7', '7 ', 'inf', '-Infinity', '1_0', '0x1', '+3',
         '.5', '1.', '2e400', '0.30000000000000004', '18.150550842285156']


def test_csv_cells_two_by_two_type_as_pandas(tmp_path):
    """Every pair of ``CELLS`` as a two-row column: the dtype and the
    values ``pd.read_csv`` gives."""
    pairs = list(itertools.product(CELLS, repeat=2))
    path = tmp_path / 'pairs.csv'
    with open(path, 'w', newline='') as fh:
        writer = csv.writer(fh, lineterminator='\n')
        writer.writerow([f'c{i}' for i in range(len(pairs))])
        writer.writerow([a for a, _ in pairs])
        writer.writerow([b for _, b in pairs])
    want, got = pd.read_csv(path), read_csv(str(path))

    def kind(column):
        if column.dtype == object or pd.api.types.is_string_dtype(
                column.dtype):
            return 'object'
        return str(column.dtype)

    def value(v):
        if isinstance(v, np.generic):
            v = v.item()
        return 'nan' if isinstance(v, float) and v != v else (type(v), v)

    for i in range(len(pairs)):
        name = f'c{i}'
        assert (kind(got[name]), [value(v) for v in got[name]]) == \
            (kind(want[name]), [value(v) for v in want[name].tolist()]), \
            pairs[i]


# -------------------------------------------------------------- executor
@pytest.fixture()
def data_folders(tmp_path, monkeypatch):
    monkeypatch.setattr(mlcomp_tpu, 'DATA_FOLDER', str(tmp_path / 'jax'))
    monkeypatch.setattr(mlcomp_tpu_torch, 'DATA_FOLDER',
                        str(tmp_path / 'port'))
    rng = np.random.RandomState(11)
    table = pd.DataFrame({
        'image': [f'{i}.png' for i in range(50)],
        'label': rng.choice(['a', 'b', 'c'], 50),
        'patient': rng.randint(0, 12, 50),
        'score': np.round(rng.rand(50), 3)})
    table.loc[3, 'score'] = np.nan
    for side in ('jax', 'port'):
        os.makedirs(tmp_path / side / 'p')
        table.to_csv(tmp_path / side / 'p' / 'labels.csv', index=False)
    return tmp_path


@pytest.mark.parametrize('variant,spec', [
    ('frame', {'label': 'label'}),
    ('group', {'group_column': 'patient'}),
    ('stratified_group', {'label': 'label', 'group_column': 'patient'}),
    ('count', {'count': 37}),
])
def test_split_executor_writes_jaxs_fold_csv(data_folders, variant, spec):
    executor = dict(type='split', variant=variant, n_splits=4, seed=2,
                    **spec)
    if variant != 'count':
        executor['file'] = 'labels.csv'
    config = {'info': {'name': 's', 'project': 'p'},
              'executors': {'split': executor}}
    got = Executor.from_config('split', Config(config))
    want = JaxExecutor.from_config('split', JaxConfig(config))
    for ex in (got, want):
        ex.step = None
    got_result, want_result = got.work(), want.work()
    assert got_result['rows'] == want_result['rows']
    assert (data_folders / 'port' / 'p' / 'fold.csv').read_bytes() == \
        (data_folders / 'jax' / 'p' / 'fold.csv').read_bytes()


def test_split_executor_refuses_an_unknown_variant(data_folders):
    config = {'info': {'name': 's', 'project': 'p'},
              'executors': {'split': {'type': 'split', 'variant': 'x'}}}
    for registry, cfg in ((Executor, Config), (JaxExecutor, JaxConfig)):
        ex = registry.from_config('split', cfg(config))
        with pytest.raises(ValueError, match="unknown split variant 'x'"):
            ex.work()


# ------------------------------------------------------- contrib commands
def _run_both(tmp_path, argv_of):
    """JAX's click command through ``CliRunner`` and the port's ``main``
    with the same arguments, each writing its own csv: (exit codes,
    outputs, the two files' bytes)."""
    jax_out, port_out = tmp_path / 'jax.csv', tmp_path / 'port.csv'
    result = CliRunner().invoke(jax_contrib, argv_of(jax_out))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = port_contrib(argv_of(port_out))
    files = [p.read_bytes() if p.exists() else None
             for p in (port_out, jax_out)]
    return (code, result.exit_code), (out.getvalue() + err.getvalue(),
                                      result.output), files


def _images(folder, names):
    folder.mkdir(parents=True, exist_ok=True)
    for name in names:
        (folder / name).write_bytes(b'x')


@pytest.mark.parametrize('regex', [None, r'(\w+)_\d'])
def test_split_classify_is_jaxs(tmp_path, regex):
    for cls, n in (('cat', 7), ('dog', 5), ('eel', 3)):
        _images(tmp_path / 'imgs' / cls,
                [f'g{i % 3}_{i}.png' for i in range(n)])
    (tmp_path / 'imgs' / 'stray.txt').write_text('not a class')
    extra = ['--group-regex', regex] if regex else []
    codes, outputs, files = _run_both(tmp_path, lambda out: [
        'split-classify', str(tmp_path / 'imgs'), '3', *extra,
        '--out', str(out)])
    assert codes == (0, 0)
    assert files[0] == files[1] and files[0].startswith(b'image,label,fold')
    assert outputs[0].replace('port.csv', 'X') == \
        outputs[1].replace('jax.csv', 'X')


def test_split_segment_and_test_img_are_jaxs(tmp_path):
    _images(tmp_path / 'imgs', [f'im{i}.png' for i in range(9)])
    _images(tmp_path / 'masks', [f'im{i}.npy' for i in range(0, 9, 2)])
    (tmp_path / 'imgs' / 'subdir').mkdir()
    codes, outputs, files = _run_both(tmp_path, lambda out: [
        'split-segment', str(tmp_path / 'imgs'), str(tmp_path / 'masks'),
        '2', '--out', str(out)])
    assert codes == (0, 0) and files[0] == files[1]
    codes, outputs, files = _run_both(tmp_path, lambda out: [
        'split-test-img', str(tmp_path / 'imgs'), '--out', str(out)])
    assert codes == (0, 0) and files[0] == files[1]
    assert files[0].count(b'\n') == 10      # the header and 9 images


def test_split_frame_is_jaxs(tmp_path):
    rng = np.random.RandomState(4)
    pd.DataFrame({'id': np.arange(30), 'y': rng.randint(0, 3, 30),
                  'w': rng.rand(30)}).to_csv(tmp_path / 'in.csv',
                                             index=False)
    codes, outputs, files = _run_both(tmp_path, lambda out: [
        'split-frame', str(tmp_path / 'in.csv'), 'y', '5',
        '--out', str(out)])
    assert codes == (0, 0) and files[0] == files[1]


@pytest.mark.parametrize('command', ['split-classify', 'split-segment',
                                     'split-test-img'])
def test_contrib_errors_are_jaxs(tmp_path, command):
    (tmp_path / 'empty').mkdir()
    (tmp_path / 'empty2').mkdir()
    args = {'split-classify': ['3'], 'split-segment': [
        str(tmp_path / 'empty2'), '3'], 'split-test-img': []}[command]
    codes, outputs, files = _run_both(tmp_path, lambda out: [
        command, str(tmp_path / 'empty'), *args, '--out', str(out)])
    assert codes == (1, 1) and files == [None, None]
    assert outputs[0].strip() == outputs[1].strip()
    assert outputs[0].startswith('Error: ')


def test_the_contrib_command_imports_no_torch(tmp_path):
    """``python -m mlcomp_tpu_torch.contrib`` where torch, pandas and
    click are unimportable."""
    _images(tmp_path / 'imgs' / 'a', ['1.png', '2.png'])
    _images(tmp_path / 'imgs' / 'b', ['3.png'])
    blocker = tmp_path / 'block'
    blocker.mkdir()
    for name in ('torch', 'pandas', 'click'):
        (blocker / f'{name}.py').write_text(
            f"raise ImportError('{name} is blocked')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-m', 'mlcomp_tpu_torch.contrib', 'split-classify',
         str(tmp_path / 'imgs'), '2', '--out', str(tmp_path / 'f.csv')],
        cwd=repo, env={**os.environ,
                       'PYTHONPATH': f'{blocker}{os.pathsep}{repo}'},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / 'f.csv').read_text().splitlines()[0] == \
        'image,label,fold'


# ------------------------------------------------------------ submission
@pytest.mark.parametrize('columns', [{}, {'id_column': 'Id',
                                          'label_column': 'Category',
                                          'out': 'other'}])
def test_submit_classify_writes_jaxs_csv(tmp_path, monkeypatch, columns):
    rng = np.random.RandomState(8)
    x = rng.rand(23, 4, 4, 1).astype(np.float32)
    np.savez(tmp_path / 'test.npz', x=x, y=np.zeros(23))
    out = {}
    for side, registry in (('port', Executor), ('jax', JaxExecutor)):
        folder = tmp_path / side
        os.makedirs(folder / 'data' / 'pred')
        np.save(folder / 'data' / 'pred' / 'm.npy',
                np.random.RandomState(9).rand(23, 6).astype(np.float32))
        monkeypatch.chdir(folder)
        ex = registry.get('submit_classify')(
            dataset={'path': str(tmp_path / 'test.npz')}, y="load('m')",
            part_size=10, **columns)
        ex.step = None
        assert ex.work() == {'folder': os.path.join('data', 'submissions')}
        name = columns.get('out', 'submission')
        out[side] = (folder / 'data' / 'submissions' /
                     f'{name}.csv').read_bytes()
    assert out['port'] == out['jax']
    assert out['port'].count(b'\n') == 24

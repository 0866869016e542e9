"""The port's export consumers against the JAX package's, on the CPU: the
Equation language, ``infer_classify`` / ``valid_classify`` /
``valid_segment``, test-time augmentation, the numpy metrics, the
array-file dataset with its fold file, and ``examples/ensemble`` run end
to end through the port's executors.

Inputs come from numpy seeds. Exports are written by the port (its
trainer or ``export_model``) and read by both packages. The JAX
executors run through ``.work()`` (no DB session), as the JAX package's
own tests call them; the port's take ``device='cpu'``. Tolerances are
stated where they are used.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu.contrib import dataset as jax_dataset
from mlcomp_tpu.contrib import metrics as jax_metrics
from mlcomp_tpu.contrib.transform import tta as jax_tta
from mlcomp_tpu.worker.executors import Executor as JaxExecutor
from mlcomp_tpu.worker.executors.base.equation import (
    Equation as JaxEquation,
)
from mlcomp_tpu_torch.contrib import dataset as port_dataset
from mlcomp_tpu_torch.contrib import metrics as port_metrics
from mlcomp_tpu_torch.contrib.transform import tta as port_tta
from mlcomp_tpu_torch.convert import variables_to_jax
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.train.export import export_model, make_predictor
from mlcomp_tpu_torch.worker.executors import Executor
from mlcomp_tpu_torch.worker.executors.base.equation import Equation
from mlcomp_tpu_torch.worker.executors.infer import InferClassify
from mlcomp_tpu_torch.worker.executors.valid import (
    ValidClassify, ValidSegment,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 predictions of one export through JAX's jitted predictor and the
#: port's eager one: the same math in another summation order (softmax
#: probabilities, measured below 1e-6)
PRED_TOL = 1e-5


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _pair(**kwargs):
    return JaxEquation(**kwargs), Equation(device='cpu', **kwargs)


# ---------------------------------------------------------------- grammar
class TestEvaluator:
    @pytest.mark.parametrize('expr', [
        '(1 + 2) * 3', '2 ** 3 / 4', '-5 + 1', '+2 - -3', 'b', 'a',
        'some_name', '[1, 2, 3]', '(1, a)', 'mean([1, 2, 3])',
        'mean(1, 3)', 'mean([[1, 2], [3, 4]])', "'text'", 'b * c',
        'c'])
    def test_same_values(self, expr):
        attrs = {'a': '1 + 1', 'b': 'a * 10', 'c': 'undefined_name'}
        jax_eq, port_eq = _pair(**attrs)
        want, got = jax_eq._solve(expr), port_eq._solve(expr)
        assert type(got) is type(want)
        np.testing.assert_array_equal(np.asarray(got, dtype=object),
                                      np.asarray(want, dtype=object))

    @pytest.mark.parametrize('expr', [
        '__import__("os")', 'a.b', '[x for x in y]', '1 % 2', 'not 1',
        'open("f")', 'lambda: 1', '1 < 2', 'x[0]', '1 // 2', '~1',
        'load.__class__', 'f"{a}"'])
    def test_same_refusals(self, expr):
        messages = []
        for eq in _pair():
            with pytest.raises(ValueError) as e:
                eq._solve(expr)
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    def test_cache_names_keep_a_result(self):
        for eq in _pair(a='1 + 1', cache_names=['a']):
            assert list(eq.solve('a', [(0, 1), (1, 2)])) == [2, 2]
            assert eq.cache == {'a': 2}

    @pytest.mark.parametrize('count,max_count,part_size', [
        (10, None, None), (10, None, 4), (10, 6, 4), (10, 3, None),
        (0, None, None), (0, None, 4), (7, 100, 7), (9, None, 2)])
    def test_same_parts(self, count, max_count, part_size):
        jax_eq, port_eq = _pair(max_count=max_count, part_size=part_size)
        assert port_eq.generate_parts(count) == \
            jax_eq.generate_parts(count)

    @pytest.mark.parametrize('kind,suffix', [
        ('npy', ''), ('npz', ''), ('npy', 'fold0'), ('bare', '')])
    def test_load_slices_by_part(self, in_tmp, kind, suffix):
        os.makedirs('data/pred')
        data = np.random.RandomState(0).rand(10, 3).astype(np.float32)
        stem = 'm' + (f'_{suffix}' if suffix else '')
        path = os.path.join('data', 'pred', stem)
        if kind == 'npz':
            np.savez(path + '.npz', y=data)
        elif kind == 'npy':
            np.save(path + '.npy', data)
        else:                       # a file saved under the bare name
            with open(path, 'wb') as fh:
                np.save(fh, data)
        parts = [(0, 4), (4, 8), (8, 10)]
        outs = []
        for eq in _pair(suffix=suffix, name='m'):
            eq.y = "load('m') * 2"
            outs.append(list(eq.solve('y', parts)))
        for got, want, (lo, hi) in zip(outs[1], outs[0], parts):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, data[lo:hi] * 2)

    def test_missing_predictions_raise_alike(self, in_tmp):
        messages = []
        for eq in _pair():
            with pytest.raises(FileNotFoundError) as e:
                eq.load('absent')
            messages.append(str(e.value))
        assert messages[0] == messages[1]


# ------------------------------------------------------------ tta, metrics
class TestTta:
    @pytest.mark.parametrize('specs', [
        [], ['hflip'], ['vflip'], ['transpose'], ['hflip', 'vflip'],
        ['hflip', 'vflip', 'transpose']])
    @pytest.mark.parametrize('ndim', [3, 4])
    def test_same_views_and_average(self, specs, ndim):
        rng = np.random.RandomState(len(specs) + ndim)
        x = rng.rand(*(3, 5, 5, 2)[:ndim]).astype(np.float32)
        w = rng.rand(x[0].size, 4).astype(np.float32)

        def predict(batch):   # a fixed map, spatial out for 4-D inputs
            flat = np.ascontiguousarray(batch).reshape(len(batch), -1) @ w
            return np.ascontiguousarray(batch) * 2 if ndim == 4 else flat

        jax_t, port_t = jax_tta.parse_tta(specs), port_tta.parse_tta(specs)
        assert [t.name for t in port_t] == [t.name for t in jax_t]
        for jt, pt in zip(jax_t, port_t):
            np.testing.assert_array_equal(pt.forward(x), jt.forward(x))
            np.testing.assert_array_equal(pt.inverse(x), jt.inverse(x))
        np.testing.assert_array_equal(
            port_tta.tta_predict(predict, x, port_t),
            jax_tta.tta_predict(predict, x, jax_t))

    def test_unknown_view_raises(self):
        with pytest.raises(KeyError):
            port_tta.parse_tta(['rotate'])


class TestMetrics:
    @pytest.mark.parametrize('seed', range(4))
    @pytest.mark.parametrize('name', ['accuracy', 'f1_macro',
                                      'confusion_matrix', 'per_class_prf',
                                      'dice_numpy', 'iou_numpy'])
    def test_same_values(self, name, seed):
        rng = np.random.RandomState(seed)
        n = [50, 1, 0, 200][seed]
        if name in ('dice_numpy', 'iou_numpy'):
            args = [rng.rand(n, 4) > 0.5, rng.rand(n, 4) > 0.6]
        else:
            args = [rng.randint(0, 5, n), rng.randint(0, 5, n)]
        if n == 0 and name in ('f1_macro', 'per_class_prf'):
            args.append(5)
        got = getattr(port_metrics, name)(*args)
        want = getattr(jax_metrics, name)(*args)
        for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                        np.atleast_1d(np.asarray(want, dtype=object))):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- dataset
class TestNpzDataset:
    @pytest.fixture()
    def files(self, in_tmp):
        rng = np.random.RandomState(0)
        x = rng.rand(20, 4, 4, 1).astype(np.float32)
        y = rng.randint(0, 3, 20)
        np.savez('d.npz', x=x, y=y)
        with open('fold.csv', 'w') as fh:
            fh.write('image,fold\n')
            for i in range(20):
                fh.write(f'{i}.png,{i % 4}\n')
        return x, y

    @pytest.mark.parametrize('fold_number,is_test,max_count', [
        (None, False, None), (0, False, None), (0, True, None),
        (3, True, 2), (1, False, 7)])
    def test_same_arrays(self, files, fold_number, is_test, max_count):
        kw = dict(path='d.npz', fold_number=fold_number, is_test=is_test,
                  max_count=max_count, fold_csv='fold.csv')
        want = jax_dataset.NpzDataset(**kw)
        got = port_dataset.NpzDataset(**kw)
        assert len(got) == len(want)
        for g, w in zip(got.arrays(), want.arrays()):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize('part', ['train', 'valid', 'test'])
    def test_executors_read_the_same_split(self, files, part):
        os.makedirs('data')
        shutil.move('fold.csv', os.path.join('data', 'fold.csv'))
        spec = {'path': 'd.npz', 'fold_csv': 'fold.csv', 'fold_number': 1}
        jax_ex = JaxExecutor.get('valid_classify')(dataset=spec)
        port_ex = Executor.get('valid_classify')(dataset=spec,
                                                 device='cpu')
        for g, w in zip(port_ex.load_dataset_arrays(part),
                        jax_ex.load_dataset_arrays(part)):
            np.testing.assert_array_equal(g, w)

    def test_image_folders_are_not_ported(self, files):
        """Image folders are read now: the executors' ``img_folder:``
        branch gives JAX's arrays, ``is_test`` by the part as JAX
        defaults it (``tests/test_torch_port_images.py`` holds the
        datasets themselves)."""
        x, y = files
        os.makedirs('imgs')
        for i in range(20):
            np.save(os.path.join('imgs', f'{i}.npy'), x[i])
        with open('fold.csv', 'w') as fh:
            fh.write('image,label,fold\n')
            for i in range(20):
                fh.write(f'{i}.npy,{y[i]},{i % 4}\n')
        spec = {'img_folder': 'imgs', 'fold_csv': 'fold.csv',
                'fold_number': 2}
        for part in ('train', 'valid'):
            ex = Executor.get('infer_classify')(
                model_name='m', dataset=spec, device='cpu')
            jax_ex = JaxExecutor.get('infer_classify')(
                model_name='m', dataset=spec)
            got = ex.load_dataset_arrays(part)
            for g, w in zip(got, jax_ex.load_dataset_arrays(part)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert len(got[0]) == (15 if part == 'train' else 5)


# --------------------------------------------------------------- executors
_IMAGES = {'name': 'synthetic_images', 'n_train': 64, 'n_valid': 40,
           'image_size': 8, 'channels': 3}
_MODELS = {
    'mlp': {'name': 'mlp', 'num_classes': 10, 'hidden': [32],
            'dtype': 'float32'},
    'resnet18': {'name': 'resnet18', 'num_classes': 10, 'dtype': 'float32',
                 'norm': 'batch', 'num_filters': 8},
    'vit': {'name': 'vit', 'num_classes': 10, 'image_size': 8,
            'patch_size': 4, 'd_model': 32, 'n_layers': 2, 'n_heads': 2,
            'd_ff': 64, 'dtype': 'float32'},
}


def _export(name, model_spec, input_shape, seed=0):
    """A port model with weights from ``seed`` exported to
    models/<name>; returns it."""
    model = create_model(**model_spec, device='cpu',
                         input_shape=input_shape,
                         generator=torch.Generator().manual_seed(seed))
    if model_spec['name'] == 'resnet18':
        # running statistics away from 0/1, so eval mode reads them
        with torch.no_grad():
            for key, buf in model.named_buffers():
                buf.copy_(torch.rand(buf.shape, generator=torch.Generator()
                                     .manual_seed(seed)) + 0.5)
    variables = variables_to_jax(model)
    export_model(os.path.join('models', name), variables['params'],
                 model_spec, batch_stats=variables.get('batch_stats'),
                 meta={'input_shape': list(input_shape)})
    return model


class TestInferClassify:
    @pytest.mark.parametrize('model,tta,part_size', [
        ('mlp', (), None), ('mlp', ('hflip', 'vflip'), None),
        ('mlp', (), 7), ('mlp', ('hflip',), 16),
        ('resnet18', ('hflip', 'vflip'), 16), ('vit', ('hflip',), None)])
    def test_same_predictions_as_jax(self, in_tmp, model, tta, part_size):
        _export('m', _MODELS[model], (8, 8, 3))
        kw = dict(model_name='m', dataset=_IMAGES, batch_size=16,
                  tta=list(tta), part_size=part_size)
        JaxExecutor.get('infer_classify')(**kw).work()
        want = np.load('data/pred/m.npy')
        result = Executor.get('infer_classify')(**kw, device='cpu')()
        got = np.load('data/pred/m.npy')
        assert result == {'count': 40, 'name': 'm'}
        assert got.shape == want.shape == (40, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)

    def test_int8_equation_is_the_int8_predictor(self, in_tmp):
        spec = {'name': 'mlp', 'num_classes': 10, 'hidden': [256],
                'dtype': 'float32'}
        data = dict(_IMAGES, image_size=16, channels=1)
        _export('q', spec, (16, 16, 1))
        ex = Executor.from_config('i', {'executors': {'i': {
            'type': 'infer_classify', 'model_name': 'q', 'dataset': data,
            'y': "infer(batch_size=16, quantize='int8')",
            'device': 'cpu'}}})
        ex()
        (predict,) = ex._predictors.values()
        want = make_predictor('models/q', batch_size=16,
                              activation='softmax', quantize='int8',
                              device='cpu')
        assert predict.quantized == want.quantized == 1
        np.testing.assert_array_equal(np.load('data/pred/q.npy'),
                                      want(ex.x))

    def test_predictor_is_kept_across_parts(self, in_tmp):
        _export('m', _MODELS['mlp'], (8, 8, 3))
        ex = Executor.get('infer_classify')(
            model_name='m', dataset=_IMAGES, part_size=8,
            tta=['hflip', 'vflip'], device='cpu')
        ex()
        assert len(ex._predictors) == 1


class TestValid:
    @pytest.mark.parametrize('metric', ['accuracy', 'f1_macro'])
    @pytest.mark.parametrize('part_size', [None, 7])
    def test_classify_scores_as_jax(self, in_tmp, metric, part_size):
        rng = np.random.RandomState(3)
        x = rng.rand(30, 2).astype(np.float32)
        y = rng.randint(0, 4, 30)
        np.savez('d.npz', x=x, y=y)
        os.makedirs('data/pred')
        np.save('data/pred/p.npy', rng.rand(30, 4).astype(np.float32))
        np.save('data/pred/q.npy', rng.rand(30, 4).astype(np.float32))
        kw = dict(dataset={'path': 'd.npz'}, metric=metric,
                  part_size=part_size, y="(load('p') + load('q')) / 2")
        want = JaxExecutor.get('valid_classify')(**kw).work()
        got = Executor.get('valid_classify')(**kw, device='cpu')()
        assert got == want
        mean = (np.load('data/pred/p.npy') + np.load('data/pred/q.npy')) / 2
        if metric == 'accuracy':
            assert got['score'] == float((mean.argmax(-1) == y).mean())

    @pytest.mark.parametrize('metric', ['iou', 'dice'])
    @pytest.mark.parametrize('preds', ['probs', 'ids', 'empty'])
    def test_segment_scores_as_jax(self, in_tmp, metric, preds):
        rng = np.random.RandomState(4)
        masks = rng.randint(0, 3, (12, 6, 6))
        if preds == 'empty':
            masks = np.zeros_like(masks)
        np.savez('d.npz', x=rng.rand(12, 6, 6, 1).astype(np.float32),
                 y=masks)
        os.makedirs('data/pred')
        out = rng.rand(12, 6, 6, 3).astype(np.float32)
        np.save('data/pred/s.npy', out.argmax(-1) if preds == 'ids' else
                np.zeros_like(out) if preds == 'empty' else out)
        kw = dict(dataset={'path': 'd.npz'}, metric=metric, part_size=5,
                  name='s')
        want = JaxExecutor.get('valid_segment')(**kw).work()
        got = Executor.get('valid_segment')(**kw, device='cpu')()
        assert got == want

    def test_segment_metric_is_checked(self):
        with pytest.raises(ValueError, match="'iou' or 'dice'"):
            ValidSegment(metric='f1', device='cpu')


class TestRegistry:
    @pytest.mark.parametrize('name,cls', [
        ('infer_classify', InferClassify), ('valid_classify', ValidClassify),
        ('valid_segment', ValidSegment), ('equation', Equation),
        ('infer', None), ('valid', None)])
    def test_builtin_names_resolve_to_the_port(self, name, cls):
        got = Executor.get(name)
        assert got.__module__.startswith('mlcomp_tpu_torch.')
        if cls is not None:
            assert got is cls

    @pytest.mark.parametrize('name', ['equation', 'infer_classify',
                                      'valid_classify', 'valid_segment'])
    def test_entry_points_need_the_card_or_cpu(self, in_tmp, name):
        if torch.cuda.is_available():
            pytest.skip('a CUDA card is present')
        kwargs = {'dataset': {'path': 'd.npz'}, 'y': '1'}
        ex = Executor.from_config('e', {'executors': {'e': {
            'type': name, **({} if name == 'equation' else kwargs)}}})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex()


# ------------------------------------------------------- the ensemble DAG
def _dag_order(executors):
    order = []

    def visit(name):
        deps = executors[name].get('depends') or []
        for dep in [deps] if isinstance(deps, str) else deps:
            visit(dep)
        if name not in order:
            order.append(name)

    for name in executors:
        visit(name)
    return order


def test_ensemble_example_runs_on_the_port(tmp_path, monkeypatch):
    """``examples/ensemble/config.yml`` through the port's executors on the
    CPU, cut to 1 epoch and 512/128 images (``type: jax_train`` read as
    the port's ``train``); JAX's ``InferClassify`` and ``ValidClassify``
    over the port's exports give the same predictions (PRED_TOL) and the
    same score."""
    with open(os.path.join(REPO, 'examples', 'ensemble', 'config.yml')) \
            as fh:
        config = yaml.safe_load(fh)
    executors = config['executors']
    for spec in executors.values():
        spec['dataset'].update(n_train=512, n_valid=128)
        spec['device'] = 'cpu'
        if spec['type'] == 'jax_train':
            spec['type'] = 'train'
            spec['stages'][0]['epochs'] = 1
            spec['checkpoint_dir'] = str(tmp_path / 'ck' / spec['model_name'])
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    results = {name: Executor.from_config(name, config)()
               for name in _dag_order(executors)}
    assert set(results) == set(executors)
    # JAX's consumers over the port's exports, in a directory of their own
    shutil.copytree(port_dir / 'models', jax_dir / 'models')
    monkeypatch.chdir(jax_dir)
    for name in ('infer_a', 'infer_b', 'valid_ens'):
        spec = {k: v for k, v in executors[name].items()
                if k not in ('type', 'depends', 'device')}
        jax_result = JaxExecutor.get(executors[name]['type'])(**spec).work()
        if name == 'valid_ens':
            assert jax_result == results[name]
    for name in ('a', 'b'):
        got = np.load(port_dir / 'data' / 'pred' / f'{name}.npy')
        want = np.load(jax_dir / 'data' / 'pred' / f'{name}.npy')
        assert got.shape == (128, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=PRED_TOL)

"""The port's pretrained-weight loading and the trainer's export-side keys
against the JAX package's, on the CPU: ``load_pretrained_variables``,
``merge_pretrained``'s summary and values (the MLP, a ResNet-18 with
``batch_stats`` at ``num_filters=8``, a 2-layer ViT; head swaps),
``apply_pretrained``, and the ``train`` executor's ``model.params_file``
and ``infer_valid``.

JAX's trainer is never the oracle here: under pytest-xdist its
``params_file`` path is unsteady (ROADMAP.md, C). The JAX side is its
loader and merge, called directly on trees made from numpy seeds.
Merged values are compared exactly: a merge copies or casts, it does no
arithmetic.
"""

import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu.train import JaxTrain
from mlcomp_tpu.train import pretrained as jax_pretrained
from mlcomp_tpu_torch.convert import to_tensor, variables_to_jax
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.train import pretrained
from mlcomp_tpu_torch.train.export import (
    export_model, load_export, make_predictor,
)
from mlcomp_tpu_torch.train.loop import TrainState
from mlcomp_tpu_torch.worker.executors import Executor

SPECS = {
    'mlp': ({'name': 'mlp', 'num_classes': 10, 'hidden': [16, 8],
             'dtype': 'float32'}, (8, 8, 1)),
    'resnet18': ({'name': 'resnet18', 'num_classes': 10,
                  'dtype': 'float32', 'norm': 'batch',
                  'num_filters': 8}, (8, 8, 3)),
    'vit': ({'name': 'vit', 'num_classes': 10, 'image_size': 8,
             'patch_size': 4, 'd_model': 32, 'n_layers': 2, 'n_heads': 2,
             'd_ff': 64, 'dtype': 'float32'}, (8, 8, 3)),
}


def _jax_variables(spec, shape, seed):
    """The JAX init tree of ``spec`` (its paths, shapes and dtypes, by
    ``jax.eval_shape``: nothing is computed) with values from a numpy
    seed; running variances positive."""
    model = jax_create_model(**spec)
    tree = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, *shape), jnp.float32))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        v = rng.randn(*s.shape) * 0.2
        if path[-1].key == 'var':
            v = np.abs(v) + 0.5
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf,
                                            nn.meta.unbox(dict(tree)))


def _port_model(spec, shape, seed=0):
    return create_model(**spec, device='cpu', input_shape=shape,
                        generator=torch.Generator().manual_seed(seed))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(to_tensor(got[path]).numpy(),
                                      np.asarray(want[path]))


def _summary(s):
    return (sorted(s.loaded), sorted(s.reinit), sorted(s.missing))


# ------------------------------------------------------------------ loader
class TestLoad:
    @pytest.mark.parametrize('prefix', ['params/', ''])
    def test_npz_as_jax_reads_it(self, tmp_path, prefix):
        rng = np.random.RandomState(0)
        arrays = {f'{prefix}dense_0/kernel': rng.rand(4, 3),
                  f'{prefix}dense_0/bias': rng.rand(3).astype(np.float32),
                  f'{prefix}head/kernel': rng.rand(3, 2)}
        if prefix:
            arrays['batch_stats/bn/mean'] = rng.rand(3)
        path = str(tmp_path / 'w.npz')
        np.savez(path, **arrays)
        got = pretrained.load_pretrained_variables(path)
        _assert_same_tree(got, jax_pretrained.load_pretrained_variables(
            path))
        assert 'params' in got

    @pytest.mark.parametrize('model', sorted(SPECS))
    @pytest.mark.parametrize('suffix', ['', '.msgpack'])
    def test_export_as_jax_reads_it(self, tmp_path, model, suffix):
        spec, shape = SPECS[model]
        variables = variables_to_jax(_port_model(spec, shape))
        base = str(tmp_path / model)
        export_model(base, variables['params'], spec,
                     batch_stats=variables.get('batch_stats'))
        got = pretrained.load_pretrained_variables(base + suffix)
        _assert_same_tree(got, jax_pretrained.load_pretrained_variables(
            base + suffix))
        assert ('batch_stats' in got) == (model == 'resnet18')

    @pytest.mark.parametrize('name', ['nope.msgpack', 'nope', 'nope.npz'])
    def test_missing_file_raises_alike(self, tmp_path, name):
        messages = []
        for loader in (jax_pretrained, pretrained):
            with pytest.raises(FileNotFoundError) as e:
                loader.load_pretrained_variables(str(tmp_path / name))
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    def test_npz_nesting_under_a_leaf_raises_alike(self, tmp_path):
        path = str(tmp_path / 'bad.npz')
        np.savez(path, **{'params/a': np.zeros(2), 'params/a/b': np.ones(2)})
        messages = []
        for loader in (jax_pretrained, pretrained):
            with pytest.raises(ValueError) as e:
                loader.load_pretrained_variables(path)
            messages.append(str(e.value))
        assert messages[0] == messages[1]


# ------------------------------------------------------------------- merge
class TestMerge:
    @pytest.mark.parametrize('model,classes', [
        ('mlp', 10), ('mlp', 5), ('resnet18', 10), ('resnet18', 5),
        ('vit', 10), ('vit', 5)])
    def test_summary_and_values_are_jax_s(self, model, classes):
        """A 10-class tree merged into a ``classes``-class model: JAX's
        summary, path for path, from the port's own init tree; loaded
        leaves take the file's values, the rest keep the port's init."""
        spec, shape = SPECS[model]
        loaded = _jax_variables(spec, shape, seed=1)
        target = dict(spec, num_classes=classes)
        jax_init = _jax_variables(target, shape, seed=2)
        _, want = jax_pretrained.merge_pretrained(jax_init, loaded)
        port_init = variables_to_jax(_port_model(target, shape))
        merged, got = pretrained.merge_pretrained(port_init, loaded)
        assert _summary(got) == _summary(want)
        assert str(got) == str(want)
        assert bool(got.reinit) == (classes != 10)
        merged_leaves = dict(_leaves(merged))
        for path, leaf in _leaves(port_init):
            source = loaded if path in got.loaded else port_init
            expect = dict(_leaves(source))[path]
            np.testing.assert_array_equal(
                to_tensor(merged_leaves[path]).numpy(),
                to_tensor(expect).numpy())

    def test_cast_to_the_init_leaf_dtype_as_jax(self):
        """An f32 file leaf into a bf16 init leaf rounds as JAX's cast."""
        value = np.random.RandomState(0).randn(6, 5).astype(np.float32)
        loaded = {'params': {'w': {'kernel': value}}}
        jax_init = {'params': {'w': {'kernel': jnp.zeros((6, 5),
                                                         jnp.bfloat16)}}}
        port_init = {'params': {'w': {'kernel': torch.zeros(
            6, 5, dtype=torch.bfloat16)}}}
        want, _ = jax_pretrained.merge_pretrained(jax_init, loaded)
        got, _ = pretrained.merge_pretrained(port_init, loaded)
        got = got['params']['w']['kernel']
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want['params']['w']['kernel']).view(np.int16))

    def test_other_collections_pass_through(self):
        init = {'params': {'a': {'kernel': np.zeros((2, 2), np.float32)}},
                'cache': {'k': np.zeros(3)}}
        loaded = {'params': {'a': {'kernel': np.ones((2, 2), np.float32)}},
                  'cache': {'k': np.ones(3)}}
        merged, summary = pretrained.merge_pretrained(init, loaded)
        assert merged['cache'] is init['cache']
        assert _summary(summary) == _summary(
            jax_pretrained.merge_pretrained(init, loaded)[1])

    @pytest.mark.parametrize('init_model,file_model', [
        ('resnet18', 'mlp'), ('mlp', 'vit'), ('vit', 'resnet18')])
    def test_zero_matches_raise_jax_s_error(self, init_model, file_model):
        # another class count, or the heads' biases would match
        spec, shape = SPECS[file_model]
        loaded = _jax_variables(dict(spec, num_classes=7), shape, seed=1)
        ispec, ishape = SPECS[init_model]
        messages = []
        for module, init in (
                (jax_pretrained, _jax_variables(ispec, ishape, seed=2)),
                (pretrained, variables_to_jax(_port_model(ispec, ishape)))):
            with pytest.raises(ValueError, match='ZERO') as e:
                module.merge_pretrained(init, loaded)
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    @pytest.mark.parametrize('model', sorted(SPECS))
    def test_apply_loads_the_model_in_place(self, tmp_path, model):
        """``apply_pretrained`` on a fresh state: the model then holds the
        export's weights (and running statistics) bit for bit, and gives
        JAX's logits on the file's variables."""
        spec, shape = SPECS[model]
        variables = _jax_variables(spec, shape, seed=3)
        base = str(tmp_path / 'w')
        export_model(base, variables['params'], spec,
                     batch_stats=variables.get('batch_stats'))
        port = _port_model(spec, shape)
        state, summary = pretrained.apply_pretrained(
            TrainState(step=0, model=port, opt_state=None), base)
        assert state.model is port
        assert not summary.reinit and not summary.missing
        _assert_same_tree(variables_to_jax(port), variables)
        x = np.random.RandomState(4).rand(3, *shape).astype(np.float32)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        apply = jax.jit(lambda v, x: jax_create_model(**spec).apply(
            v, x, train=False))
        want = np.asarray(apply(variables, jnp.asarray(x)))
        # f32 on both sides, the same weights: summation order only
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- trainer
_DATA = {'name': 'synthetic_images', 'n_train': 64, 'n_valid': 24,
         'image_size': 8, 'channels': 1}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _spec(tmp_path, model=None, **over):
    return {'type': 'train', 'model': dict(model or SPECS['mlp'][0]),
            'dataset': dict(_DATA), 'batch_size': 16,
            'stages': [{'name': 's1', 'epochs': 1, 'optimizer': {
                'name': 'adam', 'lr': 1e-2}}],
            'checkpoint_dir': str(tmp_path / 'ck'), 'device': 'cpu',
            **over}


def _train(tmp_path, spec):
    log = logging.getLogger(f'test_port_pretrained_{id(spec)}')
    log.setLevel(logging.INFO)
    lines = _Lines()
    log.addHandler(lines)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        result = Executor.from_config('train', {'executors': {
            'train': spec}})(logger=log)
    finally:
        os.chdir(cwd)
        log.removeHandler(lines)
    return result, lines.lines


class TestTrainerParamsFile:
    def test_starts_from_the_files_values(self, tmp_path):
        """With lr 0 the run's export is its starting point: the file's
        values, exactly; the summary is logged as JAX logs it."""
        spec, shape = SPECS['mlp']
        variables = _jax_variables(spec, shape, seed=5)
        np.savez(str(tmp_path / 'w.npz'), **{
            '/'.join(p): v for p, v in _leaves(variables)})
        run = _spec(tmp_path, model=dict(spec, params_file='w.npz'),
                    model_name='ft')
        run['stages'][0]['optimizer']['lr'] = 0.0
        _, lines = _train(tmp_path, run)
        assert any(line.startswith('pretrained w.npz: 6 leaves loaded')
                   for line in lines)
        exported, exported_spec = load_export(str(tmp_path / 'models' /
                                                  'ft'))
        _assert_same_tree(exported, variables)
        assert 'params_file' not in exported_spec

    def test_batch_stats_load_before_the_first_step(self, tmp_path,
                                                    monkeypatch):
        spec, shape = SPECS['resnet18']
        variables = _jax_variables(spec, shape, seed=6)
        variables['batch_stats'] = jax.tree.map(
            lambda a: a + 0.25, variables['batch_stats'])
        export_model(str(tmp_path / 'rn'), variables['params'], spec,
                     batch_stats=variables['batch_stats'])
        seen = {}
        apply = pretrained.apply_pretrained

        def keep(state, params_file):
            state, summary = apply(state, params_file)
            seen['state'] = variables_to_jax(state.model)
            seen['summary'] = summary
            return state, summary

        monkeypatch.setattr(pretrained, 'apply_pretrained', keep)
        run = _spec(tmp_path, model=dict(spec, params_file='rn'),
                    dataset=dict(_DATA, channels=3))
        _train(tmp_path, run)
        assert not seen['summary'].reinit and not seen['summary'].missing
        _assert_same_tree(seen['state'], variables)

    def test_head_swap(self, tmp_path):
        spec, shape = SPECS['mlp']
        variables = _jax_variables(spec, shape, seed=7)
        export_model(str(tmp_path / 'ten'), variables['params'], spec)
        run = _spec(tmp_path, model=dict(spec, num_classes=4,
                                         params_file='ten'),
                    dataset=dict(_DATA, num_classes=4))
        result, lines = _train(tmp_path, run)
        assert result['best_score'] is not None
        (line,) = [x for x in lines if x.startswith('pretrained ten:')]
        assert '4 leaves loaded, 2 shape-mismatched' in line
        assert 'params/head/kernel (8, 10)->(8, 4)' in line

    def test_checkpoint_resume_wins(self, tmp_path):
        _train(tmp_path, _spec(tmp_path))
        run = _spec(tmp_path, model=dict(SPECS['mlp'][0],
                                         params_file='absent.npz'))
        result, lines = _train(tmp_path, run)
        assert result['samples_per_sec'] == 0       # fully resumed
        assert not any(line.startswith('pretrained') for line in lines)

    def test_wrong_architecture_fails_loudly(self, tmp_path):
        spec, shape = SPECS['vit']
        variables = _jax_variables(spec, shape, seed=8)
        export_model(str(tmp_path / 'vit'), variables['params'], spec)
        with pytest.raises(ValueError, match='ZERO'):
            _train(tmp_path, _spec(tmp_path, model=dict(
                SPECS['mlp'][0], params_file='vit')))


class TestTrainerInferValid:
    def _run(self, tmp_path, **infer_valid):
        # main_metric loss, maximized: the best checkpoint is epoch 0's
        # (the valid loss falls), not the final state
        run = _spec(tmp_path, model_name='m', main_metric='loss',
                    infer_valid=infer_valid or {'out_prefix': None})
        run['stages'][0]['epochs'] = 3
        return _train(tmp_path, run)

    def test_best_only_saves_the_best_checkpoints_predictions(self,
                                                              tmp_path):
        from mlcomp_tpu_torch.train.data import create_dataset
        _, lines = self._run(tmp_path)
        pred = tmp_path / 'data' / 'pred'
        got = np.load(pred / 'm.npy')
        data = create_dataset(**_DATA)
        np.testing.assert_array_equal(np.load(pred / 'm_y.npy'),
                                      data['y_valid'])
        # the export is written from the best checkpoint too
        want = make_predictor(str(tmp_path / 'models' / 'm'),
                              activation='softmax', device='cpu',
                              batch_size=16)(data['x_valid'])
        assert got.shape == (24, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1, atol=1e-5)
        assert any('infer_valid: 24 predictions' in x for x in lines)

    def test_final_state_without_best_only(self, tmp_path):
        from mlcomp_tpu_torch.train.data import create_dataset
        from mlcomp_tpu_torch.train.export import export_from_checkpoint
        self._run(tmp_path, out_prefix='final', best_only=False)
        got = np.load(tmp_path / 'data' / 'pred' / 'final.npy')
        export_from_checkpoint(str(tmp_path / 'ck' / 'last.msgpack'),
                               SPECS['mlp'][0], str(tmp_path / 'last'))
        data = create_dataset(**_DATA)
        last = make_predictor(str(tmp_path / 'last'), activation='softmax',
                              device='cpu', batch_size=16)(data['x_valid'])
        best = make_predictor(str(tmp_path / 'models' / 'm'),
                              activation='softmax', device='cpu',
                              batch_size=16)(data['x_valid'])
        np.testing.assert_allclose(got, last, rtol=0, atol=1e-6)
        assert np.abs(got - best).max() > 1e-3     # best is not the last

    def test_prefix_defaults_to_valid_without_model_name(self, tmp_path):
        _train(tmp_path, _spec(tmp_path, infer_valid={'best_only': False}))
        assert (tmp_path / 'data' / 'pred' / 'valid.npy').exists()

    def test_unloadable_best_falls_back_to_the_final_state(
            self, tmp_path, monkeypatch):
        from mlcomp_tpu_torch.train import executor as port_executor
        restore = port_executor.restore_checkpoint

        def no_best(directory, target=None, kind='last'):
            if kind == 'best':
                raise ValueError('checkpoint params do not fit the model')
            return restore(directory, target, kind)

        monkeypatch.setattr(port_executor, 'restore_checkpoint', no_best)
        _, lines = self._run(tmp_path, out_prefix='p')
        assert any('best checkpoint not loadable' in x for x in lines)
        got = np.load(tmp_path / 'data' / 'pred' / 'p.npy')
        assert got.shape == (24, 10)

    @pytest.mark.parametrize('over,raises', [
        ({'model_name': 'm'}, True),
        ({'infer_valid': {'out_prefix': 'p'}}, True),
        ({'infer_valid': {'best_only': False}}, False),
        ({}, False)])
    def test_checkpoint_every_zero_error_is_jax_s(self, tmp_path, over,
                                                  raises):
        kw = dict(checkpoint_every=0, **over)
        messages = []
        for make in (lambda: JaxTrain(**kw),
                     lambda: Executor.get('train')(**kw, device='cpu')):
            if raises:
                with pytest.raises(ValueError) as e:
                    make()
                messages.append(str(e.value))
            else:
                make()
        assert len(set(messages)) == (1 if raises else 0)

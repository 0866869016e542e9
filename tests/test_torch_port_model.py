"""The port's transformer_lm against the JAX package's, on the CPU.

A small LM (vocab 128, d_model 64, 2 layers, 4 heads, d_ff 128, T=128)
is initialised by JAX; its weights cross to the port through
``convert.params_from_jax`` in both ``scan_layers`` layouts, and the
same tokens (numpy, from a seed) go through both forwards. JAX runs its
Pallas attention under the interpreter (``attn_impl='interpret'``), as
its own tests do; the port reads that spec value as ``auto``, which on
the CPU is the kernel's plain version.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as jax_create_model
from mlcomp_tpu_torch.convert import params_from_jax, params_to_jax
from mlcomp_tpu_torch.models import create_model, model_names, param_count
from mlcomp_tpu_torch.models.transformer import embed_lookup
from mlcomp_tpu_torch.train import layer_stack

#: f32 logits: both sides compute in f32 on the CPU; only summation
#: order differs (measured max |diff| ~5e-6 at |logits| ~4)
F32_ATOL = 1e-4
#: bf16 activations: the two frameworks round at different places over
#: 2 layers (measured max |diff| ~0.08 at |logits| ~4, i.e. a few bf16
#: ulps); the bound is 4% of the largest logit, plus top-1 agreement
BF16_REL = 0.04
BF16_TOP1 = 0.95

SPEC = {'name': 'transformer_lm', 'vocab_size': 128, 'd_model': 64,
        'n_layers': 2, 'n_heads': 4, 'd_ff': 128, 'max_seq_len': 128,
        'attn_impl': 'interpret'}


def _tokens(b=2, t=128, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int32)


def _jax_model(dtype, scan, seed=0):
    spec = {**SPEC, 'dtype': dtype, 'scan_layers': scan}
    model = jax_create_model(**spec)
    variables = model.init(jax.random.PRNGKey(seed), _tokens(1))
    params = jax.tree.map(np.asarray, nn.meta.unbox(variables['params']))
    return spec, model, params


def _port_model(spec, params):
    model = create_model(**spec, device='cpu')
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _logits_both(dtype, scan, tokens):
    spec, jmodel, params = _jax_model(dtype, scan)
    ref = np.asarray(jnp.asarray(
        jmodel.apply({'params': params}, tokens), jnp.float32))
    with torch.no_grad():
        out = _port_model(spec, params)(torch.from_numpy(tokens))
    return out.float().numpy(), ref


class TestForwardParity:
    @pytest.mark.parametrize('scan', [True, False])
    def test_f32_logits_match(self, scan):
        out, ref = _logits_both('float32', scan, _tokens())
        assert np.abs(out - ref).max() < F32_ATOL

    @pytest.mark.parametrize('scan', [True, False])
    def test_bf16_logits_match(self, scan):
        out, ref = _logits_both('bfloat16', scan, _tokens(seed=1))
        assert np.abs(out - ref).max() <= BF16_REL * np.abs(ref).max()
        assert (out.argmax(-1) == ref.argmax(-1)).mean() >= BF16_TOP1

    def test_head_dtype_f32_and_non_causal(self):
        spec, jmodel, _ = _jax_model('float32', True)
        spec = {**spec, 'head_dtype': 'float32', 'causal': False}
        jmodel = jax_create_model(**spec)
        params = jax.tree.map(np.asarray, nn.meta.unbox(
            jmodel.init(jax.random.PRNGKey(3), _tokens(1))['params']))
        tokens = _tokens(seed=4)
        ref = np.asarray(jmodel.apply({'params': params}, tokens))
        with torch.no_grad():
            out = _port_model(spec, params)(torch.from_numpy(tokens))
        assert out.dtype == torch.float32
        assert np.abs(out.numpy() - ref).max() < F32_ATOL

    def test_short_ragged_sequence(self):
        """T=17: the leading position embeddings, and no T % 128 rule in
        the port (JAX's Pallas kernel has one, so JAX runs dense here)."""
        spec, _, params = _jax_model('float32', True)
        tokens = _tokens(t=17, seed=5)
        jmodel = jax_create_model(**{**spec, 'attn_impl': 'dense'})
        ref = np.asarray(jmodel.apply({'params': params}, tokens))
        with torch.no_grad():
            out = _port_model(spec, params)(torch.from_numpy(tokens))
        assert out.shape == (2, 17, 128)
        assert np.abs(out.numpy() - ref).max() < F32_ATOL


class TestOutOfRangeTokens:
    def test_embed_lookup_is_jnp_take(self):
        table = np.arange(8, dtype=np.float32).reshape(4, 2)
        ids = np.array([0, 5, -1, -4, -5, 4, 3])
        ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids),
                                  axis=0))
        out = embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
        np.testing.assert_array_equal(out.numpy(), ref)   # NaN == NaN

    def test_model_reproduces_jax_on_bad_ids(self):
        """An id >= V gives JAX a NaN embedding row, which NaN-poisons
        every position it is attended with; a negative id wraps. The
        port computes the same result without indexing out of range."""
        spec, jmodel, params = _jax_model('float32', True)
        tokens = _tokens(b=2, t=128, seed=6)
        tokens[0, 5] = 128 + 7
        tokens[1, 3] = -2
        ref = np.asarray(jmodel.apply({'params': params}, tokens))
        with torch.no_grad():
            out = _port_model(spec, params)(torch.from_numpy(tokens))
        out = out.numpy()
        np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
        assert np.isnan(out[0]).any() and not np.isnan(out[1]).any()
        finite = ~np.isnan(ref)
        assert np.abs(out[finite] - ref[finite]).max() < F32_ATOL


class TestConversion:
    @pytest.mark.parametrize('scan', [True, False])
    def test_params_to_jax_round_trip(self, scan):
        spec, _, params = _jax_model('float32', scan)
        sd = params_from_jax(params)
        back = params_to_jax(sd, n_heads=SPEC['n_heads'], stacked=scan)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        again = params_from_jax(back)
        assert all(torch.equal(again[k], sd[k]) for k in sd)

    def test_state_dict_keys_and_shapes(self):
        spec, _, params = _jax_model('float32', True)
        sd = params_from_jax(params)
        model = create_model(**spec, device='cpu')
        assert set(sd) == set(model.state_dict())
        assert sd['layers.1.attn.qkv.weight'].shape == (3 * 64, 64)
        assert sd['layers.0.attn.out.weight'].shape == (64, 64)
        assert sd['layers.0.mlp.wo.weight'].shape == (64, 128)
        assert sd['lm_head.weight'].shape == (128, 64)
        assert param_count(sd) == param_count(model) == sum(
            np.asarray(x).size for x in jax.tree.leaves(params))

    def test_bf16_leaves_cross_bit_for_bit(self):
        spec, _, params = _jax_model('float32', True)
        bf = jax.tree.map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
        sd = params_from_jax(bf)
        assert sd['embed'].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            sd['embed'].float().numpy(),
            np.asarray(bf['embed'], np.float32))

    def test_stacked_and_per_layer_load_the_same_weights(self):
        _, _, params = _jax_model('float32', True)
        stacked = params_from_jax(params)
        per_layer = params_from_jax(
            layer_stack.unstack_layer_tree(params))
        assert all(torch.equal(stacked[k], per_layer[k]) for k in stacked)

    def test_unknown_leaves_raise(self):
        _, _, params = _jax_model('float32', False)
        params = dict(params)
        params['layer_1'] = {**params['layer_1'],
                             'moe': {'router': {'kernel': np.zeros(2)}}}
        with pytest.raises(ValueError, match='MoE layers are not ported'):
            params_from_jax(params)


class TestLayerStack:
    def test_matches_jax_package(self):
        from mlcomp_tpu.train import layer_stack as jax_stack
        _, _, params = _jax_model('float32', False)
        for fn in ('stack_layer_tree',):
            ours = getattr(layer_stack, fn)(params)
            theirs = getattr(jax_stack, fn)(params)
            assert jax.tree.structure(ours) == jax.tree.structure(theirs)
            for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
                np.testing.assert_array_equal(a, b)
        stacked = jax_stack.stack_layer_tree(params)
        ours = layer_stack.unstack_layer_tree(stacked)
        theirs = jax_stack.unstack_layer_tree(stacked)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, b)

    def test_torch_leaves_stack(self):
        tree = {'layer_0': {'w': torch.ones(2)},
                'layer_1': {'w': torch.zeros(2)}}
        stacked = layer_stack.stack_layer_tree(tree)
        assert stacked['layers']['w'].shape == (2, 2)
        back = layer_stack.unstack_layer_tree(stacked)
        assert torch.equal(back['layer_1']['w'], torch.zeros(2))

    def test_heterogeneous_stack_refused(self):
        with pytest.raises(ValueError, match='differ in structure'):
            layer_stack.stack_layer_tree(
                {'layer_0': {'a': np.zeros(1)}, 'layer_1': {'b': np.zeros(1)}})


class TestConfig:
    @pytest.mark.parametrize('override,exc,match', [
        ({'n_experts': 4}, NotImplementedError, 'MoE'),
        ({'matmul_precision': 'int4'}, ValueError, 'matmul_precision'),
        ({'matmul_precision': 'fp8'}, ValueError, 'matmul_precision'),
        ({'attn_impl': 'triton'}, ValueError, 'attn_impl'),
        ({'dtype': 'int8'}, ValueError, 'dtype'),
    ])
    def test_unported_knobs_raise(self, override, exc, match):
        with pytest.raises(exc, match=match):
            create_model(**{**SPEC, **override}, device='cpu')

    def test_mesh_raises(self):
        with pytest.raises(NotImplementedError, match='mesh'):
            create_model(**SPEC, mesh=object(), device='cpu')

    def test_other_models_not_ported(self):
        assert model_names() == ['mlp', 'resnet101', 'resnet152', 'resnet18',
                                 'resnet34', 'resnet50', 'transformer_lm']
        with pytest.raises(KeyError, match='transformer_lm'):
            create_model('vit', num_classes=3)

    def test_train_mode_not_ported(self):
        """Train mode is ported; what of it is not (MoE's auxiliary loss)
        still raises when the model is built."""
        model = create_model(**{**SPEC, 'attn_impl': 'auto'}, device='cpu')
        tokens = torch.zeros((1, 4), dtype=torch.long)
        with torch.no_grad():
            torch.testing.assert_close(model(tokens, train=True),
                                       model(tokens), rtol=0, atol=0)
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            create_model(**{**SPEC, 'n_experts': 4}, device='cpu')

    def test_dropout_and_remat_are_eval_no_ops(self):
        _, _, params = _jax_model('float32', True)
        tokens = torch.from_numpy(_tokens(b=1, t=32, seed=7))
        plain = _port_model({**SPEC, 'dtype': 'float32'}, params)
        knobs = _port_model({**SPEC, 'dtype': 'float32', 'dropout': 0.5,
                             'remat': True}, params)
        with torch.no_grad():
            assert torch.equal(plain(tokens), knobs(tokens))

    def test_init_is_seeded_by_the_generator(self):
        a = create_model(**SPEC, device='cpu',
                         generator=torch.Generator().manual_seed(1))
        b = create_model(**SPEC, device='cpu',
                         generator=torch.Generator().manual_seed(1))
        c = create_model(**SPEC, device='cpu',
                         generator=torch.Generator().manual_seed(2))
        assert torch.equal(a.embed, b.embed)
        assert not torch.equal(a.embed, c.embed)

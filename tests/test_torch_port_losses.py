"""The port's dense losses against the JAX package's, label rule included.

``softmax_ce``, ``lm_ce`` and ``seg_ce`` of ``mlcomp_tpu/train/loop.py``
go through optax's ``softmax_cross_entropy_with_integer_labels``, whose
``take_along_axis`` wraps a label in [-V, 0) to label + V and gives NaN
for one outside [-V, V). The port's losses must do the same without
raising and without indexing out of range. Inputs are made with numpy
from a seed; both sides compute in f32 on the CPU, so finite losses agree
to 1e-6 absolute (summation order only) and NaN stands exactly where JAX
puts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.train import loop as jax_loop
from mlcomp_tpu_torch.train import loop as port_loop

ATOL = 1e-6
V = 10


def _logits(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 2).astype(np.float32)


def _both(name, logits, labels, weights=None):
    """(JAX (loss, accuracy), port (loss, accuracy)) as numpy floats."""
    jw = None if weights is None else jnp.asarray(weights)
    pw = None if weights is None else torch.from_numpy(weights)
    jl, jm = getattr(jax_loop, name)(jnp.asarray(logits),
                                     jnp.asarray(labels), jw)
    pl, pm = getattr(port_loop, name)(torch.from_numpy(logits),
                                      torch.from_numpy(labels), pw)
    return ((float(jl), float(jm['accuracy'])),
            (float(pl), float(pm['accuracy'])))


def _assert_same(want, got):
    """Finite values agree to ATOL; NaN stands where JAX has NaN."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=ATOL)


#: labels of a [6, V] batch: in range, wrapped negatives, and beyond
LABEL_CASES = {
    'in_range': [0, 1, 4, 9, 3, 7],
    'negative_wraps': [-1, -V, -3, 2, -9, 5],
    'at_and_past_v': [V, V + 3, 1, 2, 100, 0],
    'below_minus_v': [-V - 1, -50, 3, -V, 4, 1],
}


class TestPerExampleRule:
    @pytest.mark.parametrize('case', sorted(LABEL_CASES))
    def test_per_example_matches_optax(self, case):
        import optax
        logits = _logits((6, V))
        labels = np.asarray(LABEL_CASES[case], np.int32)
        want = optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(labels))
        got = port_loop._ce(torch.from_numpy(logits),
                            torch.from_numpy(labels))
        _assert_same(np.asarray(want), got.numpy())

    def test_three_rows_wrap_and_nan(self):
        """Logits [3, 10] from seed 0: [1, 9, -1] wraps the last label,
        [1, 9, 10] gives NaN for it."""
        logits = torch.from_numpy(
            np.random.RandomState(0).randn(3, 10).astype(np.float32))
        wrap = port_loop._ce(logits, torch.tensor([1, 9, -1]))
        assert torch.isfinite(wrap).all()
        assert wrap[2] == port_loop._ce(logits, torch.tensor([1, 9, 9]))[2]
        nan = port_loop._ce(logits, torch.tensor([1, 9, 10]))
        assert torch.isnan(nan[2]) and torch.isfinite(nan[:2]).all()

    def test_out_of_range_labels_compute_without_raising(self):
        """A label far outside [-V, V) is gathered at a clamped index:
        the loss is NaN, no IndexError and no host sync on the way."""
        logits = torch.zeros(4, V, requires_grad=True)
        labels = torch.tensor([10 ** 6, -(10 ** 6), V, -V - 1])
        per = port_loop._ce(logits, labels)
        assert torch.isnan(per).all()
        per.sum().backward()                  # the gradient path too
        assert logits.grad.shape == (4, V)


class TestLosses:
    @pytest.mark.parametrize('case', sorted(LABEL_CASES))
    def test_softmax_ce(self, case):
        logits = _logits((6, V), seed=1)
        labels = np.asarray(LABEL_CASES[case], np.int32)
        want, got = _both('softmax_ce', logits, labels)
        _assert_same(want, got)

    @pytest.mark.parametrize('case', sorted(LABEL_CASES))
    def test_softmax_ce_weighted(self, case):
        logits = _logits((6, V), seed=2)
        labels = np.asarray(LABEL_CASES[case], np.int32)
        weights = np.asarray([1, 0, 1, 1, 0, 1], np.float32)
        want, got = _both('softmax_ce', logits, labels, weights)
        _assert_same(want, got)

    @pytest.mark.parametrize('token', [3, -1, -V, V, V + 7, -V - 2])
    def test_lm_ce(self, token):
        """A next token equal to V (or past it) makes its sequence's loss
        NaN in both; a negative one wraps."""
        rng = np.random.RandomState(3)
        logits = _logits((2, 5, V), seed=3)
        tokens = rng.randint(0, V, (2, 5)).astype(np.int32)
        tokens[0, 2] = token
        want, got = _both('lm_ce', logits, tokens)
        _assert_same(want, got)

    @pytest.mark.parametrize('case', ['in_range', 'negative_wraps',
                                      'at_and_past_v', 'below_minus_v'])
    def test_seg_ce(self, case):
        logits = _logits((2, 3, 4, V), seed=4)
        labels = np.random.RandomState(4).randint(0, V, (2, 3, 4)) \
            .astype(np.int32)
        labels[0, 1, :] = LABEL_CASES[case][:4]
        want, got = _both('seg_ce', logits, labels)
        _assert_same(want, got)

    def test_a_wrapped_negative_label_never_counts_as_correct(self):
        """The accuracy compares argmax with the raw label, as JAX does:
        -1 wraps in the loss but never equals an argmax."""
        logits = np.zeros((2, V), np.float32)
        logits[:, V - 1] = 5.0
        labels = np.asarray([-1, V - 1], np.int32)
        want, got = _both('softmax_ce', logits, labels)
        _assert_same(want, got)
        assert got[1] == 0.5

"""``core/continual.py``'s online diagonal Fisher (``fisher_diag_update``)
against the JAX package's on the same numpy trees: an EMA of g^2 in f32
over every leaf of a nested tree, at atol 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as core
from repro_torch.utils.tree import params_from_numpy, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nested(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": {"v": (scale * rng.standard_normal(5)).astype(np.float32),
                  "a": (scale * rng.standard_normal(())).astype(np.float32)}}


def assert_trees_equal_jax(got, want, atol=1e-7):
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("seed", range(3))
def test_fisher_from_nothing_is_the_squares(seed):
    grads = nested(np.random.default_rng(seed), scale=3.0)
    got = core.fisher_diag_update(None, params_from_numpy(grads, "cpu"))
    want = jax_core.fisher_diag_update(None, jax.tree.map(jnp.asarray, grads))
    assert list(got) == list(grads) and list(got["b"]) == list(grads["b"])
    assert_trees_equal_jax(got, want)


@pytest.mark.parametrize("decay", [0.95, 0.5])
@pytest.mark.parametrize("seed", range(3))
def test_fisher_ema_matches_jax(decay, seed):
    rng = np.random.default_rng(100 + seed)
    fisher = jax.tree.map(np.abs, nested(rng))
    grads = nested(rng, scale=2.0)
    got = core.fisher_diag_update(params_from_numpy(fisher, "cpu"),
                                  params_from_numpy(grads, "cpu"), decay)
    want = jax_core.fisher_diag_update(jax.tree.map(jnp.asarray, fisher),
                                       jax.tree.map(jnp.asarray, grads),
                                       decay)
    assert_trees_equal_jax(got, want)


def test_fisher_ema_of_the_reference_test():
    """``tests/test_continual.py::test_fisher_ema``'s values."""
    f = core.fisher_diag_update(None, {"w": torch.full((3,), 2.0)})
    torch.testing.assert_close(f["w"], torch.full((3,), 4.0))
    f2 = core.fisher_diag_update(f, {"w": torch.zeros(3)}, decay=0.5)
    torch.testing.assert_close(f2["w"], torch.full((3,), 2.0))


def test_fisher_squares_other_dtypes_in_f32():
    g = {"w": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    f = core.fisher_diag_update(None, g)
    assert f["w"].dtype == torch.float32
    torch.testing.assert_close(f["w"], torch.tensor([2.25, 4.0]))

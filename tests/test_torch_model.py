"""The port's forecaster, loss, anchored SGD step and parameter trees
against the JAX package on the same inputs.

Parameters are initialised by JAX and carried into the port through the
weights bridge (``utils.tree.params_from_numpy``): JAX's PRNG cannot be
reproduced in torch.  Width is small (hidden 16, batch 3) but the scan is
the real 672 + 96 steps.  Tolerances: forward atol 1e-5, loss gradient
rtol 1e-4 / atol 1e-6, one anchored SGD step atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.solar_lstm import SolarLSTMConfig as JaxConfig
from repro.core import continual as jax_continual
from repro.models.lstm import SolarForecaster as JaxForecaster
from repro.training.fed_solar import make_solar_fns as jax_make_solar_fns
from repro.training.losses import solar_loss as jax_solar_loss
from repro.utils.tree import flatten_params as jax_flatten
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core import continual
from repro_torch.models.lstm import SolarForecaster
from repro_torch.training.fed_solar import make_solar_fns
from repro_torch.training.losses import solar_loss
from repro_torch.utils.tree import (
    flatten_params,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
    unflatten_params,
)

HIDDEN, BATCH = 16, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """JAX params and forecasters of both packages, plus one batch."""
    jfc = JaxForecaster(JaxConfig(hidden_size=HIDDEN))
    jparams = jfc.init(jax.random.key(3))
    np_params = jax.tree.map(np.asarray, jparams)
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=HIDDEN))
    rng = np.random.default_rng(0)
    cfg = fc.cfg
    batch = {
        "history": rng.uniform(0, 1, (BATCH, cfg.history_steps,
                                      cfg.history_channels)).astype(np.float32),
        "forecast": rng.uniform(0, 1, (BATCH, cfg.horizon_steps,
                                       cfg.forecast_channels)).astype(np.float32),
        "target": rng.uniform(0, 0.5, (BATCH, cfg.horizon_steps)).astype(np.float32),
    }
    return jfc, jparams, np_params, fc, batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------ trees
def test_leaf_order_matches_jax(setup):
    _, jparams, np_params, _, _ = setup
    params = params_from_numpy(np_params, "cpu")
    assert list(params) == list(np_params)        # keys keep their order
    np.testing.assert_array_equal(flatten_params(params).numpy(),
                                  np.asarray(jax_flatten(jparams)))


def test_unflatten_and_bridge_round_trip(setup):
    _, _, np_params, _, _ = setup
    params = params_from_numpy(np_params, "cpu")
    back = unflatten_params(flatten_params(params), params)
    for a, b in zip(tree_leaves(back), tree_leaves(params), strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)),
                    jax.tree.leaves(np_params), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="template needs"):
        unflatten_params(torch.zeros(3), params)


def test_init_matches_schema_shapes(setup):
    jfc, jparams, _, fc, _ = setup
    params = fc.init(torch.Generator().manual_seed(0), "cpu")
    again = fc.init(torch.Generator().manual_seed(0), "cpu")
    for a, b, j in zip(tree_leaves(params), tree_leaves(again),
                       jax.tree.leaves(jparams), strict=True):
        assert tuple(a.shape) == j.shape and a.dtype == torch.float32
        assert torch.equal(a, b)
    assert torch.count_nonzero(params["encoder"]["b"]) == 0
    assert torch.count_nonzero(params["head_b"]) == 0


# ------------------------------------------------------------ forecaster
def test_forward_matches_jax(setup):
    jfc, jparams, np_params, fc, batch = setup
    want = np.asarray(jfc.forward(jparams, jnp.asarray(batch["history"]),
                                  jnp.asarray(batch["forecast"])))
    got = fc.forward(params_from_numpy(np_params, "cpu"),
                     torch.from_numpy(batch["history"]),
                     torch.from_numpy(batch["forecast"]))
    assert got.shape == (BATCH, fc.cfg.horizon_steps)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_loss_gradient_matches_jax_grad(setup):
    jfc, jparams, np_params, fc, batch = setup
    jb = jax_batch(batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_solar_loss(jfc, p, jb)[0])(jparams)
    live = tree_map(lambda x: x.requires_grad_(),
                    params_from_numpy(np_params, "cpu"))
    loss, _ = solar_loss(fc, live, torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


def test_anchored_sgd_step_matches_jax(setup):
    """Port: task gradient through the LSTM autograd.Function, anchor
    gradient through the ewc_update route.  JAX: autodiff of
    loss + 0.5 * lam * sum (p - anchor)^2."""
    jfc, jparams, np_params, fc, batch = setup
    lam, lr = 0.05, 1e-2
    # an anchor away from the params, so the penalty gradient matters
    anchor_np = jax.tree.map(lambda x: x + np.float32(0.3), np_params)
    jstep, _ = jax_make_solar_fns(jfc, lr=lr)
    jnew, _ = jstep(jparams, jax_batch(batch),
                    jax.tree.map(jnp.asarray, anchor_np), jnp.float32(lam))
    step, _ = make_solar_fns(fc, lr=lr)
    params = params_from_numpy(np_params, "cpu")
    anchor = continual.EWCState(
        flatten_params(params_from_numpy(anchor_np, "cpu")), None, lam)
    new, _ = step(params, torch_batch(batch), anchor)
    np.testing.assert_allclose(flatten_params(new).numpy(),
                               np.asarray(jax_flatten(jnew)), atol=1e-5)
    # and without an anchor (the centralized baselines)
    jnew0, _ = jstep(jparams, jax_batch(batch), None, jnp.float32(0.0))
    new0, _ = step(params, torch_batch(batch), None)
    np.testing.assert_allclose(flatten_params(new0).numpy(),
                               np.asarray(jax_flatten(jnew0)), atol=1e-5)


# ------------------------------------------------------------ continual
@pytest.mark.parametrize("with_fisher", [False, True])
def test_ewc_functions_match_jax(with_fisher, rng):
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    anchor = jax.tree.map(
        lambda x: (x + rng.standard_normal(x.shape)).astype(np.float32), tree)
    fisher = (jax.tree.map(lambda x: np.abs(x).astype(np.float32), tree)
              if with_fisher else None)
    jstate = jax_continual.make_anchor(jax.tree.map(jnp.asarray, anchor),
                                       None if fisher is None else
                                       jax.tree.map(jnp.asarray, fisher), 0.7)
    state = continual.make_anchor(params_from_numpy(anchor, "cpu"),
                                  None if fisher is None else
                                  params_from_numpy(fisher, "cpu"), 0.7)
    jp = jax.tree.map(jnp.asarray, tree)
    p = params_from_numpy(tree, "cpu")
    jpen, jgrads = jax_continual.ewc_penalty_and_grad(jp, jstate)
    pen, grads = continual.ewc_penalty_and_grad(p, state)
    np.testing.assert_allclose(float(pen), float(jpen), rtol=1e-5)
    np.testing.assert_allclose(float(continual.ewc_penalty(p, state)),
                               float(jax_continual.ewc_penalty(jp, jstate)),
                               rtol=1e-5)
    for g, jg in zip(tree_leaves(grads), jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)
    # the fused flat route gives the same gradient and penalty
    g0 = rng.standard_normal(17).astype(np.float32)
    flat_state = continual.EWCState(
        flatten_params(state.anchor),
        None if fisher is None else flatten_params(state.fisher), 0.7)
    jflat_state = jax_continual.EWCState(
        jax_flatten(jstate.anchor),
        None if fisher is None else jax_flatten(jstate.fisher), 0.7)
    got_g, got_pen = continual.ewc_adjusted_gradient(
        torch.from_numpy(g0), flatten_params(p), flat_state)
    want_g, want_pen = jax_continual.ewc_adjusted_gradient(
        jnp.asarray(g0), jax_flatten(jp), jflat_state)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_pen), float(want_pen), rtol=1e-4)

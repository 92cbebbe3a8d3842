"""The port's cluster-parallel tier against the JAX package's, on the CPU.

``tests/test_cluster_parallel.py``'s setup in both packages: reduced
gemma-2b, K = 3 clusters, ``sgd(5e-3)``, ``grad_clip=0``, one
``lm_batch(structure=1.0)`` of 2 x 16 a cluster, the JAX-initialised
parameters carried to the port by the weights bridge.  The port's step
runs the inner train step once a cluster; JAX's maps it with ``vmap``.
Tolerances are the reference test's: losses rtol 1e-5, parameters rtol
1e-4 and atol 1e-6 (against JAX's step and against the port's own
independent steps), the global tier rtol 1e-4 and atol 1e-6 against
JAX's ``global_params`` and the port's ``multi_aggregate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.core.cluster_parallel import ClusterParallel as JaxClusterParallel
from repro.data.lm_synth import lm_batch as jax_lm_batch
from repro.models.model import build_model as jax_build_model
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core.aggregation import multi_aggregate
from repro_torch.core.cluster_parallel import ClusterParallel
from repro_torch.models.model import build_model
from repro_torch.optim import sgd
from repro_torch.training.train_step import TrainState, build_train_step
from repro_torch.utils.tree import params_from_numpy, tree_leaves, tree_map

K = 3
COUNTS = [100, 300, 600]


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
    jcfg = jax_reduced(jax_get_config("gemma-2b"))
    jmodel = jax_build_model(jcfg)
    jopt = jax_sgd(5e-3)
    jcp = JaxClusterParallel(jmodel, jcfg, jopt, n_clusters=K, grad_clip=0.0)
    rng = np.random.default_rng(0)
    batches = [jax_lm_batch(rng, 2, 16, jcfg.vocab_size, structure=1.0)
               for _ in range(K)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jstate = jcp.init(jax.random.key(0))
    jnew, jmetrics = jax.jit(jcp.step)(
        jstate, {k: jnp.asarray(v) for k, v in stacked.items()})
    params0 = params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))), "cpu")

    cfg = reduced_for_smoke(get_config("gemma-2b"))
    model = build_model(cfg)
    model.init = lambda generator, device=None, dtype=None: params0
    opt = sgd(5e-3)
    cp = ClusterParallel(model, cfg, opt, n_clusters=K, grad_clip=0.0)
    state = cp.init(torch.Generator().manual_seed(0), "cpu")
    new, metrics = cp.step(state, {k: torch.as_tensor(v)
                                   for k, v in stacked.items()})
    return dict(cfg=cfg, model=model, opt=opt, cp=cp, state=state, new=new,
                metrics=metrics, batches=batches, params0=params0, jcp=jcp,
                jnew=jnew, jmetrics=jmetrics)


def take(tree, k):
    return tree_map(lambda x: x[k], tree)


def test_init_stacks_one_global_model(setup):
    for x, p in zip(tree_leaves(setup["state"].params),
                    tree_leaves(setup["params0"]), strict=True):
        assert x.shape == (K,) + tuple(p.shape)
        for k in range(K):
            assert torch.equal(x[k], p)


def test_matches_jax(setup):
    loss, jloss = setup["metrics"]["loss"], np.asarray(setup["jmetrics"]["loss"])
    assert tuple(loss.shape) == (K,)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-5)
    got = tree_leaves(setup["new"].params)
    want = jax.tree.leaves(setup["jnew"].params)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_matches_independent_training(setup):
    inner = build_train_step(setup["model"], setup["cfg"], setup["opt"],
                             grad_clip=0.0)
    p0, opt = setup["params0"], setup["opt"]
    for k in range(K):
        ref, ref_m = inner(TrainState(p0, opt.init(p0)),
                           {n: torch.as_tensor(v)
                            for n, v in setup["batches"][k].items()})
        np.testing.assert_allclose(setup["metrics"]["loss"][k].item(),
                                   ref_m["loss"].item(), rtol=1e-5)
        for a, b in zip(tree_leaves(take(setup["new"].params, k)),
                        tree_leaves(ref.params), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_global_tier_is_fedavg(setup):
    g = setup["cp"].global_params(setup["new"], COUNTS)
    jg = setup["jcp"].global_params(setup["jnew"], COUNTS)
    fold = multi_aggregate([take(setup["new"].params, k) for k in range(K)],
                           COUNTS)
    for a, b, c in zip(tree_leaves(g), jax.tree.leaves(jg), tree_leaves(fold),
                       strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4, atol=1e-6)


def test_broadcast_global_resync(setup):
    cp = setup["cp"]
    g = cp.global_params(setup["new"], [1, 1, 1])
    resynced = cp.broadcast_global(setup["new"], g)
    for leaf in tree_leaves(resynced.params):
        assert torch.equal(leaf[0], leaf[2])
    assert resynced.opt_state is setup["new"].opt_state

"""The port's optimizers, schedules and tree helpers against the JAX
package, on the CPU.

Inputs come from seeded numpy generators and cross over as numpy arrays.
Optimizers run 5 steps on identical gradients: updates and state within
1e-6, bf16 moments bit for bit (the f32 values they round from are the
reference's own arithmetic, in its order).  ``clip_by_global_norm``
must be equal; the schedules, f32 in both, within 1e-6 relative (XLA's f32
cosine and PyTorch's differ in the last bits at some steps).  The tree
helpers: elementwise ones equal in f32 and within one bf16 rounding in
bf16 (XLA keeps ``a + b * w`` in f32 between the two operations), the
reductions (``tree_dot``, ``global_norm``) within 1e-6 relative (another
order of the sum).  The counterparts of
``tests/test_metrics_optim.py:61-96`` run the port alone.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro.models.params import count_params_analytic as jax_count
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.utils import tree as jtree
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.models.model import build_model
from repro_torch.models.params import count_params_analytic
from repro_torch.optim import (
    adamw,
    apply_updates,
    clip_by_global_norm,
    constant,
    cosine_decay,
    sgd,
    warmup_cosine,
)
from repro_torch.utils import tree as ttree
from repro_torch.utils.tree import params_from_numpy, params_to_numpy, tree_leaves

STEPS = 5
TOL = 1e-6
# the dense and SSM families the port builds
PORT_ARCHS = ["deepseek-7b", "gemma-2b", "glm4-9b", "granite-8b",
              "mamba2-370m"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "b": {"v": rng.standard_normal(7).astype(dtype),
                  "a": rng.standard_normal((2, 3)).astype(dtype)}}


def to_port(tree):
    return params_from_numpy(tree, "cpu")


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return np.asarray(params_to_numpy({"x": x})["x"])
    return np.asarray(x)


def assert_same(got, want, tol=TOL, exact=False):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l, strict=True):
        g, w = as_np(g), as_np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if exact:
            assert np.array_equal(g.view(np.uint16) if g.dtype
                                  == ml_dtypes.bfloat16 else g,
                                  w.view(np.uint16) if w.dtype
                                  == ml_dtypes.bfloat16 else w)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=tol,
                                       atol=tol)


def run_both(make_port, make_jax, seed, param_dtype=np.float32):
    """STEPS updates of each package's optimizer on the same numpy params
    and gradients; the JAX state and updates checked after every step."""
    rng = np.random.default_rng(seed)
    params = np_tree(rng, param_dtype)
    p, jp = to_port(params), to_jax(params)
    opt, jo = make_port(), make_jax()
    st, jst = opt.init(p), jo.init(jp)
    for _ in range(STEPS):
        grads = np_tree(rng, param_dtype)
        upd, st = opt.update(to_port(grads), st, p)
        jupd, jst = jo.update(to_jax(grads), jst, jp)
        assert_same(upd, jupd)
        p, jp = apply_updates(p, upd), jopt.apply_updates(jp, jupd)
        assert_same(p, jp)
        assert int(st["step"]) == int(jst["step"])
        assert st["step"].dtype == torch.int32
    return st, jst


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_sgd_matches_jax(momentum, lr):
    port_lr = 0.05 if lr == "float" else warmup_cosine(0.05, 2, STEPS)
    jax_lr = 0.05 if lr == "float" else jsched.warmup_cosine(0.05, 2, STEPS)
    st, jst = run_both(lambda: sgd(port_lr, momentum=momentum),
                       lambda: jopt.sgd(jax_lr, momentum=momentum), seed=1)
    if momentum:
        assert_same(st["mu"], jst["mu"])


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(moments, weight_decay):
    st, jst = run_both(
        lambda: adamw(1e-2, weight_decay=weight_decay,
                      moment_dtype=getattr(torch, moments)),
        lambda: jopt.adamw(1e-2, weight_decay=weight_decay,
                           moment_dtype=getattr(jnp, moments)), seed=2)
    exact = moments == "bfloat16"
    assert_same(st["m"], jst["m"], exact=exact)
    assert_same(st["v"], jst["v"], exact=exact)


def test_adamw_on_bf16_params_matches_jax():
    """bf16 leaves: updates in f32, added in f32 and cast back."""
    run_both(lambda: adamw(1e-2), lambda: jopt.adamw(1e-2), seed=3,
             param_dtype=ml_dtypes.bfloat16)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_clip_by_global_norm_matches_jax(max_norm, dtype):
    grads = np_tree(np.random.default_rng(4), dtype)
    got, norm = clip_by_global_norm(to_port(grads), max_norm)
    want, jnorm = jopt.clip_by_global_norm(to_jax(grads), max_norm)
    assert norm.dtype == torch.float32
    assert float(norm) == float(jnorm)
    assert_same(got, want, tol=0.0)


@pytest.mark.parametrize("name", ["constant", "cosine_decay", "warmup_cosine"])
def test_schedules_equal_jax(name):
    port, ref = {
        "constant": (constant(0.3), jsched.constant(0.3)),
        "cosine_decay": (cosine_decay(1.0, 40), jsched.cosine_decay(1.0, 40)),
        "warmup_cosine": (warmup_cosine(2.0, 10, 100),
                          jsched.warmup_cosine(2.0, 10, 100)),
    }[name]
    for step in range(0, 120, 7):
        got = port(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=0.0), \
            (name, step)


# ---------------------------------------- tests/test_metrics_optim.py:61-96
def _quadratic_min(opt, steps=200):
    target = torch.tensor([3.0, -2.0])
    params = {"w": torch.zeros(2)}
    state = opt.init(params)
    for _ in range(steps):
        upd, state = opt.update({"w": params["w"] - target}, state, params)
        params = apply_updates(params, upd)
    return float((params["w"] - target).abs().max())


def test_sgd_converges():
    assert _quadratic_min(sgd(0.1)) < 1e-3


def test_sgd_momentum_converges():
    assert _quadratic_min(sgd(0.05, momentum=0.9)) < 1e-3


def test_adamw_converges():
    assert _quadratic_min(adamw(0.1)) < 1e-2


def test_adamw_bf16_moments_close_to_f32():
    a = _quadratic_min(adamw(0.1, moment_dtype=torch.float32))
    b = _quadratic_min(adamw(0.1, moment_dtype=torch.bfloat16))
    assert abs(a - b) < 0.05


def test_weight_decay_shrinks():
    opt = adamw(0.01, weight_decay=0.5)
    params = {"w": torch.tensor([10.0])}
    state = opt.init(params)
    for _ in range(50):
        upd, state = opt.update({"w": torch.zeros(1)}, state, params)
        params = apply_updates(params, upd)
    assert float(params["w"][0]) < 10.0


def test_grad_clip():
    clipped, norm = clip_by_global_norm({"w": torch.full((4,), 100.0)}, 1.0)
    assert float(torch.sqrt(torch.sum(torch.square(clipped["w"])))) \
        <= 1.0 + 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_schedules():
    s = warmup_cosine(1.0, 10, 100)
    i32 = torch.int32
    assert float(s(torch.tensor(0, dtype=i32))) == 0.0
    assert float(s(torch.tensor(10, dtype=i32))) == pytest.approx(1.0,
                                                                  abs=0.02)
    assert float(s(torch.tensor(100, dtype=i32))) == pytest.approx(0.1,
                                                                   abs=0.02)


# ------------------------------------------------------------ tree helpers
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_tree_helpers_equal_jax(dtype):
    rng = np.random.default_rng(5)
    a, b = np_tree(rng, dtype), np_tree(rng, dtype)
    pa, pb, ja, jb = to_port(a), to_port(b), to_jax(a), to_jax(b)
    assert ttree.param_count(pa) == jtree.param_count(ja)
    assert ttree.param_bytes(pa) == jtree.param_bytes(ja)
    assert_same(ttree.tree_zeros_like(pa), jtree.tree_zeros_like(ja),
                exact=True)
    elementwise = 0.0 if dtype == np.float32 else 2.0 ** -8
    assert_same(ttree.tree_add(pa, pb), jtree.tree_add(ja, jb),
                tol=elementwise)
    assert_same(ttree.tree_sub(pa, pb), jtree.tree_sub(ja, jb),
                tol=elementwise)
    assert_same(ttree.tree_scale(pa, 0.5), jtree.tree_scale(ja, 0.5),
                tol=elementwise)
    trees, weights = [pa, pb, pa], [0.2, 0.5, 0.3]
    assert_same(ttree.tree_weighted_sum(trees, weights),
                jtree.tree_weighted_sum([ja, jb, ja], weights),
                tol=elementwise)
    assert float(ttree.tree_dot(pa, pb)) == pytest.approx(
        float(jtree.tree_dot(ja, jb)), rel=1e-6)
    assert float(ttree.global_norm(pa)) == pytest.approx(
        float(jtree.global_norm(ja)), rel=1e-6)
    assert ttree.tree_allclose(pa, pa) and jtree.tree_allclose(ja, ja)
    assert ttree.tree_allclose(pa, pb) == jtree.tree_allclose(ja, jb)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_param_count_equals_the_analytic_count(arch):
    """``tests/test_param_accounting.py:18`` for the families the port
    builds: the initialised tree's count equals the analytic one, and the
    reference's."""
    assert arch in JAX_ARCHS
    cfg = reduced_for_smoke(get_config(arch))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    real = ttree.param_count(params)
    assert real == count_params_analytic(cfg, include_embed=True)
    jcfg = jax_reduced(jax_get_config(arch))
    assert real == jtree.param_count(jax_build_model(jcfg).init(
        jax.random.key(0)))
    assert real == jax_count(jcfg, include_embed=True)

"""``fedbench/reference/`` against the port on the CPU at small sizes: the
solar client update at hidden 16, a reduced Mamba-2's AdamW update (in
float32, so that the two must agree to rounding), and the server's fold.
The test imports the port to compare; the reference does not."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from fedbench import harness  # noqa: E402
from fedbench.reference import fold, mamba2, solar  # noqa: E402
from fedbench.traffic.lm_tokens import lm_batch  # noqa: E402
from fedbench.traffic.solar_fleet import generate_fleet  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "fedbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch", "jax",
                                               "jaxlib", "flax"), (path, n)


def test_solar_update_matches_the_port():
    from repro_torch.configs.solar_lstm import SolarLSTMConfig
    from repro_torch.core.continual import EWCState
    from repro_torch.models.lstm import SolarForecaster
    from repro_torch.training.fed_solar import make_solar_fns, make_train_fn

    site = generate_fleet(7, 3, 6, history_days=2)[0]
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=16))
    params = fc.init(torch.Generator().manual_seed(1), "cpu")
    anchor = {k: ({kk: vv + 0.01 for kk, vv in v.items()}
                  if isinstance(v, dict) else v + 0.01)
              for k, v in params.items()}
    sgd, _ = make_solar_fns(fc, lr=0.01)
    losses = []

    def step(p, b, a):
        new, loss = sgd(p, b, a)
        losses.append(float(loss))
        return new, loss

    rng = np.random.default_rng(3)
    state = rng.bit_generator.state
    out, _, _ = make_train_fn(step, epochs=1, batch_size=2)(
        params, site["train"], rng, EWCState(anchor, None, 0.05))
    want_losses, _, want = solar.client_update(
        params, anchor, 0.05, 0.01, site["train"], state, 2, 1, "cpu")
    assert len(losses) == len(want_losses) >= 2
    np.testing.assert_allclose(losses, [float(x) for x in want_losses],
                               rtol=1e-5)
    for got, ref in zip(solar.leaves(out), want, strict=True):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


SMALL = {"n_layers": 2, "d_model": 64, "vocab_size": 256, "d_state": 16,
         "head_dim": 16, "expand": 2, "chunk_size": 16, "n_groups": 1,
         "conv_width": 4, "norm_eps": 1e-6}


def small_model(dtype="float32"):
    from repro_torch.models.model import build_model

    drv = harness.driver("lm")
    m = {"arch": "mamba2-370m", "tie_embeddings": True, "dtype": dtype,
         **SMALL}
    cfg = drv.port_config(m)
    model = build_model(cfg)
    conf = harness.load_json(ROOT / "fedbench" / "configs" / "mamba2-370m.json")
    params = harness.init_tree(model.param_shapes(), conf["init"],
                               torch.Generator().manual_seed(2), "cpu")
    return model, cfg, params


def test_mamba2_update_matches_the_port():
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_step import TrainState, build_train_step

    model, cfg, params = small_model()
    opt = adamw(3e-4)
    step = build_train_step(model, cfg, opt, grad_clip=1.0)
    rng = np.random.default_rng(4)
    batches = [lm_batch(rng, 2, 32, 256) for _ in range(2)]
    state = TrainState(params, opt.init(params))
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if len(losses) == 1:
            m1 = [x for _, x in mamba2.leaf_slices(state.opt_state["m"], 2)]
    leaves = mamba2.leaf_slices(params, 2)
    want_losses, first, final = mamba2.client_update(
        leaves, [(b["tokens"], b["labels"]) for b in batches], SMALL, 3e-4,
        1.0)
    np.testing.assert_allclose(losses, [float(x) for x in want_losses],
                               rtol=1e-5)
    for m, g in zip(m1, first, strict=True):
        torch.testing.assert_close(m / 0.1, g, rtol=1e-3, atol=1e-7)
    got = [x for _, x in mamba2.leaf_slices(state.params, 2)]
    for a, b in zip(got, final, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_fold_matches_the_port():
    from repro_torch.core.aggregation import (
        ModelMeta,
        UpdateDelta,
        coalesced_aggregate,
    )

    g = torch.Generator().manual_seed(5)

    def tree():
        return {"a": torch.randn(7, 3, generator=g),
                "b": {"c": torch.randn(11, generator=g)}}

    base, bmeta = tree(), ModelMeta(40, 3, 5)
    ups = [(tree(), ModelMeta(8, 1, r), UpdateDelta(8, 1, 1))
           for r in (2, 4, 7, 3, 9)]        # round 7 hits the fast path
    res = coalesced_aggregate(base, bmeta, ups)
    want, meta = fold.fold(
        harness.tree_leaves(base), (40, 3, 5),
        [(harness.tree_leaves(p), (m.samples_learned, m.epochs_learned,
                                   m.round), (d.samples_learned,
                                              d.epochs_learned, d.rounds))
         for p, m, d in ups])
    assert meta == (res.meta.samples_learned, res.meta.epochs_learned,
                    res.meta.round)
    base_leaves = harness.tree_leaves(base)
    metas = [((m.samples_learned, m.epochs_learned, m.round),
              (d.samples_learned, d.epochs_learned, d.rounds))
             for _, m, d in ups]
    want64, _ = fold.fold(base_leaves, (40, 3, 5),
                          [(harness.tree_leaves(p), *mt)
                           for (p, _, _), mt in zip(ups, metas)], cast=False)
    mag, _ = fold.fold([x.abs() for x in base_leaves], (40, 3, 5),
                       [([x.abs() for x in harness.tree_leaves(p)], *mt)
                        for (p, _, _), mt in zip(ups, metas)], cast=False)
    bnds = [fold.bound(w, a, 1 + len(ups), b.dtype)
            for w, a, b in zip(want64, mag, base_leaves)]

    def share(got):
        return fold.worst_share([fold.leaf_counts(g, w, b, e) for g, w, b, e
                                 in zip(got, want64, base_leaves, bnds)])

    assert share(harness.tree_leaves(res.params)) == 0.0
    assert fold.sums((40, 3, 5), metas)
    # the same fold leaving the base as it was, or scaled by 1 + 1e-5
    assert share(base_leaves) == 1.0
    assert share([x * (1 + 1e-5) for x in want]) > 0.5


@pytest.mark.parametrize("rounds,summed", [
    ((6,), False), ((2,), True), ((2, 7), False), ((6, 3), True),
    ((2, 4, 8), False), ((2, 4, 8, 3), True)])
def test_which_folds_sum(rounds, summed):
    """Algorithm 2 takes an update whole where it was trained on the
    model's current round: base round 5, each update adds one round."""
    metas = [((8, 1, r), (8, 1, 1)) for r in rounds]
    assert fold.sums((40, 3, 5), metas) is summed

"""The whole-sequence LSTM route and the fold by leaves against the JAX
package, on the CPU.

On the CPU ``LSTMSeqFn`` runs its plain versions (``lstm_seq_ref`` forward,
``lstm_seq_bwd_ref`` backward, in the CUDA kernels' saved-tensor layout), so
these tests hold the backward's algebra and layout to ``jax.grad`` of the
reference's ``lax.scan``; the kernels themselves are held against the same
plain versions on the card (``tests/test_torch_cuda.py``).  Inputs come from
one seeded numpy generator and go through both packages.  Tolerances: the
forward atol 1e-5 (the reference tests' step tolerance), gradients rtol 1e-4
/ atol 1e-5 (the port's gradient tolerance), the float64 gradcheck at
PyTorch's eps 1e-6 / atol 1e-7; the fold atol 1e-5 (as
``tests/test_torch_kernels.py``'s fold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.solar_lstm import SolarLSTMConfig as JaxConfig
from repro.kernels.fedavg_agg.ops import aggregate_pytrees as jax_agg_trees
from repro.models.lstm import SolarForecaster as JaxForecaster
from repro.models.lstm import lstm_scan as jax_lstm_scan
from repro.training.losses import solar_loss as jax_solar_loss
from repro_torch.configs.solar_lstm import SolarLSTMConfig
from repro_torch.core.aggregation import _pad_pow2
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg.ops import (
    MAX_LEAVES,
    MAX_N,
    MAX_PTRS,
    aggregate_flat,
    aggregate_pytrees,
    pack_leaf_folds,
)
from repro_torch.kernels.fedavg_agg.ref import agg_leaves_ref
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.lstm_cell.ops import (
    LSTMSeqFn,
    lstm_seq_bwd,
    lstm_seq_fwd,
    seq_cluster,
    seq_smem,
    seq_threads,
    seq_tile,
)
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_seq_ref
from repro_torch.models.lstm import SolarForecaster, lstm_scan
from repro_torch.training.losses import solar_loss
from repro_torch.utils.tree import (
    flatten_params,
    params_from_numpy,
    tree_leaves,
)

SEQ_CASES = [(b, i, h, t) for b in (1, 3, 8) for i in (9, 10)
             for h in (4, 16, 32) for t in (1, 5, 37)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def seq_case(rng, b, i, h, t):
    """numpy (xs (b, t, i), h0, c0, wx, wh, b) at the reference's scales."""
    return (rng.standard_normal((b, t, i)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32) * 0.5,
            rng.standard_normal((b, h)).astype(np.float32) * 0.5,
            (rng.standard_normal((i, 4 * h)) * .1).astype(np.float32),
            (rng.standard_normal((h, 4 * h)) * .1).astype(np.float32),
            (rng.standard_normal(4 * h) * .1).astype(np.float32))


def jax_params(wx, wh, b):
    return {"wx": jnp.asarray(wx), "wh": jnp.asarray(wh), "b": jnp.asarray(b)}


# ------------------------------------------------------------ the forward
@pytest.mark.parametrize("B,I,H,T", SEQ_CASES)
def test_lstm_seq_plain_matches_jax_scan(B, I, H, T, rng):
    xs, h0, c0, wx, wh, b = seq_case(rng, B, I, H, T)
    jys, (jh, jc) = jax_lstm_scan(jax_params(wx, wh, b), jnp.asarray(xs),
                                  jnp.asarray(h0), jnp.asarray(c0))
    ys, cseq, gates, h, c = lstm_seq_ref(t32(xs).transpose(0, 1), t32(h0),
                                         t32(c0), t32(wx), t32(wh), t32(b))
    assert ys.shape == (T, B, H) and cseq.shape == (T, B, H)
    assert gates.shape == (T, B, 4 * H)
    for got, want in ((ys.transpose(0, 1), jys), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the saved layout: c sequence and gate activations i, f, g, o
    np.testing.assert_array_equal(cseq[-1].numpy(), c.numpy())
    i, f, g, o = gates[-1].split(H, dim=-1)
    np.testing.assert_allclose((o * torch.tanh(cseq[-1])).numpy(), h.numpy(),
                               atol=1e-6)


def test_lstm_seq_plain_is_the_step_loop(rng):
    xs, h0, c0, wx, wh, b = (t32(a) for a in seq_case(rng, 3, 10, 16, 9))
    xs = xs.transpose(0, 1)
    ys, _, _, h, c = lstm_seq_ref(xs, h0, c0, wx, wh, b)
    hh, cc = h0, c0
    for t in range(xs.shape[0]):
        hh, cc = lstm_cell_ref(xs[t], hh, cc, wx, wh, b)
        assert torch.equal(ys[t], hh)
    assert torch.equal(h, hh) and torch.equal(c, cc)


def test_lstm_seq_empty_sequence_returns_the_state(rng):
    _, h0, c0, wx, wh, b = (t32(a) for a in seq_case(rng, 2, 9, 4, 1))
    ys, h, c = LSTMSeqFn.apply(torch.zeros(0, 2, 9), h0, c0, wx, wh, b)
    assert ys.shape == (0, 2, 4)
    assert torch.equal(h, h0) and torch.equal(c, c0)


# ----------------------------------------------------------- the backward
@pytest.mark.parametrize("B,I,H,T", SEQ_CASES)
def test_lstm_seq_fn_gradients_match_jax_grad(B, I, H, T, rng):
    xs, h0, c0, wx, wh, b = seq_case(rng, B, I, H, T)
    wy = rng.standard_normal((B, T, H)).astype(np.float32)
    wh_, wc_ = (rng.standard_normal((B, H)).astype(np.float32)
                for _ in range(2))

    def jloss(xs, h0, c0, wx, wh, b):
        ys, (h, c) = jax_lstm_scan({"wx": wx, "wh": wh, "b": b}, xs, h0, c0)
        return (jnp.sum(ys * wy) + jnp.sum(h * wh_) + jnp.sum(c * wc_))
    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (xs, h0, c0, wx, wh, b)))

    args = [t32(a).requires_grad_() for a in (xs, h0, c0, wx, wh, b)]
    ys, (h, c) = lstm_scan({"wx": args[3], "wh": args[4], "b": args[5]},
                           args[0], args[1], args[2])
    loss = (ys * t32(wy)).sum() + (h * t32(wh_)).sum() + (c * t32(wc_)).sum()
    grads = torch.autograd.grad(loss, args)
    for got, want in zip(grads, jg, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("outputs", ["all", "state_only", "ys_only"])
def test_lstm_seq_fn_gradcheck_float64(outputs):
    """The encoder discards ys (no dys), the decoder's state is unused."""
    gen = torch.Generator().manual_seed(0)
    t, b, i, h = 4, 3, 2, 5
    args = [torch.randn(*s, generator=gen, dtype=torch.float64)
            .mul_(0.5).requires_grad_()
            for s in ((t, b, i), (b, h), (b, h), (i, 4 * h), (h, 4 * h),
                      (4 * h,))]

    def fn(*a):
        ys, hT, cT = LSTMSeqFn.apply(*a)
        return {"all": (ys, hT, cT), "state_only": (hT, cT),
                "ys_only": (ys,)}[outputs]
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7)


def test_lstm_seq_bwd_plain_matches_autograd_of_the_loop(rng):
    """The reverse scan's da, dh0, dc0 against autograd through the plain
    forward: da is the gradient of the gate pre-activations."""
    xs, h0, c0, wx, wh, b = (t32(a) for a in seq_case(rng, 3, 9, 16, 6))
    xs = xs.transpose(0, 1).contiguous()
    h0.requires_grad_()
    c0.requires_grad_()
    pre = []

    def cell(x, h, c):
        a = (x @ wx + h @ wh + b).requires_grad_()
        if not a.is_leaf:
            a.retain_grad()
        pre.append(a)
        i, f, g, o = a.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    h, c, ys = h0, c0, []
    for x in xs:
        h, c = cell(x, h, c)
        ys.append(h)
    dys = torch.randn(xs.shape[0], 3, 16, generator=torch.Generator()
                      .manual_seed(1))
    dh, dc = torch.ones(3, 16), torch.full((3, 16), 0.5)
    loss = (torch.stack(ys) * dys).sum() + (h * dh).sum() + (c * dc).sum()
    loss.backward()
    _, cseq, gates, _, _ = lstm_seq_fwd(xs, h0.detach(), c0.detach(), wx, wh,
                                        b)
    da, dh0, dc0 = lstm_seq_bwd(dys, dh, dc, gates, cseq, c0.detach(), wh)
    want = torch.stack([a.grad for a in pre])
    torch.testing.assert_close(da, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dh0, h0.grad, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dc0, c0.grad, rtol=1e-4, atol=1e-6)


def test_forecaster_solar_loss_gradient_matches_jax():
    """Encoder (672 steps, ys discarded) into decoder (96 steps) at hidden
    16: the hand-off of hT and cT carries the gradient back."""
    jfc = JaxForecaster(JaxConfig(hidden_size=16))
    jparams = jfc.init(jax.random.key(5))
    fc = SolarForecaster(SolarLSTMConfig(hidden_size=16))
    cfg = fc.cfg
    rng = np.random.default_rng(7)
    batch = {"history": rng.uniform(0, 1, (2, cfg.history_steps,
                                           cfg.history_channels)),
             "forecast": rng.uniform(0, 1, (2, cfg.horizon_steps,
                                            cfg.forecast_channels)),
             "target": rng.uniform(0, 0.5, (2, cfg.horizon_steps))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    jg = jax.grad(lambda p: jax_solar_loss(
        jfc, p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    live = {k: (v if not isinstance(v, dict) else
                {kk: vv.requires_grad_() for kk, vv in v.items()})
            for k, v in params.items()}
    for k in ("head_w", "head_b"):
        live[k].requires_grad_()
    loss, _ = solar_loss(fc, live, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(live))
    for got, want in zip(grads, jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- launch shapes
@pytest.mark.parametrize("hidden,in_dim,want", [
    (128, 10, 8), (128, 9, 8), (64, 10, 8), (32, 10, 8), (16, 9, 4),
    (8, 9, 2), (4, 10, 1), (12, 9, 1), (256, 10, 8)])
def test_seq_cluster_shape(hidden, in_dim, want):
    cs = seq_cluster(hidden, in_dim)
    assert cs == want
    assert hidden % (4 * cs) == 0
    tile = lstm_ops.SEQ_MAX_TILE
    assert max(seq_smem(hidden, in_dim, cs, tile)) <= lstm_ops.SEQ_MAX_SMEM
    fwd, bwd = seq_threads(hidden, cs, tile)
    assert max(fwd, bwd) <= lstm_ops.SEQ_MAX_THREADS
    assert bwd >= hidden // cs * tile // 2  # every cell thread of phase A


def test_seq_threads_at_the_forecaster_width():
    # 8 CTAs of 16 columns: one batch row a thread forward (16 x 16 rows),
    # two backward, one thread a k quad (32 x 8)
    assert seq_threads(128, 8, 16) == (256, 256)
    assert seq_threads(128, 8, 8) == (128, 128)
    assert seq_threads(128, 4, 16) == (256, 256)    # 32 x 16 / 2 rows


def test_seq_cluster_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="no cluster shape"):
        seq_cluster(6, 9)
    with pytest.raises(ValueError, match="no cluster shape"):
        seq_cluster(1024, 10)


@pytest.mark.parametrize("batch", [1, 2, 7, 8, 16, 17, 26, 33, 100, 1000])
def test_seq_tile_covers_the_batch_evenly(batch):
    tile = seq_tile(batch)
    n = -(-batch // tile)
    assert 1 <= tile <= lstm_ops.SEQ_MAX_TILE
    assert n == -(-batch // lstm_ops.SEQ_MAX_TILE)     # fewest clusters
    assert n * tile - batch < n                        # spread evenly


def test_cpu_sequence_calls_count_nothing(rng):
    reset_launch_counts()
    xs, h0, c0, wx, wh, b = (t32(a) for a in seq_case(rng, 2, 9, 4, 3))
    args = [a.requires_grad_() for a in (xs.transpose(0, 1).contiguous(),
                                         h0, c0, wx, wh, b)]
    ys, h, c = LSTMSeqFn.apply(*args)
    (ys.sum() + h.sum()).backward()
    assert launch_counts()["lstm_cell"] == 0
    assert lstm_ops.launches_seq_fwd == lstm_ops.launches_seq_bwd == 0


def test_reset_clears_the_route_counters():
    lstm_ops.launches_seq_fwd = lstm_ops.launches_seq_bwd = 3
    agg_ops.launches_leaves = 2
    reset_launch_counts()
    assert lstm_ops.launches_seq_fwd == lstm_ops.launches_seq_bwd == 0
    assert agg_ops.launches_leaves == 0


# ------------------------------------------------------ fold by leaves
def test_pack_leaf_folds_keeps_leaf_order_in_one_table():
    ptrs = [[100 * i + l for l in range(6)] for i in range(3)]
    folds = pack_leaf_folds(ptrs, [900 + l for l in range(6)], [5] * 6,
                            [0.5, 0.25, 0.25])
    assert len(folds) == 1
    f = folds[0]
    assert f["x"] == [p for row in ptrs for p in row]          # set-major
    assert f["out"] == [900 + l for l in range(6)]
    assert f["n"] == 3 and f["n_leaves"] == 6
    assert f["w"] == [0.5, 0.25, 0.25]


@pytest.mark.parametrize("n", [64, 65, 70, 127, 128, 200])
def test_pack_leaf_folds_chunks_above_64_sets(n):
    ptrs = [[1000 * i + l for l in range(6)] for i in range(n)]
    outs = [-(l + 1) for l in range(6)]
    ws = [float(i) for i in range(n)]
    folds = pack_leaf_folds(ptrs, outs, [3] * 6, ws)
    assert len(folds) == 1 + -(-(n - MAX_N) // (MAX_N - 1))
    assert folds[0]["n"] == min(n, MAX_N) and folds[0]["w"] == ws[:MAX_N]
    seen = list(range(min(n, MAX_N)))
    for f in folds[1:]:
        assert f["w"][0] == 1.0 and f["x"][:6] == outs   # the running sum
        sets = [f["x"][6 * k] // 1000 for k in range(1, f["n"])]
        assert f["w"][1:] == [ws[i] for i in sets]
        seen += sets
    assert seen == list(range(n))                          # every set, in order
    for f in folds:
        assert len(f["x"]) == f["n"] * f["n_leaves"] <= MAX_PTRS


def test_pack_leaf_folds_groups_many_leaves():
    n_leaves = 3 * MAX_LEAVES + 1
    ptrs = [[1000 * i + l for l in range(n_leaves)] for i in range(40)]
    folds = pack_leaf_folds(ptrs, list(range(n_leaves)), [1] * n_leaves,
                            [1.0] * 40)
    per = min(MAX_LEAVES, MAX_PTRS // 40)
    assert [f["out"] for f in folds] == [
        list(range(lo, min(lo + per, n_leaves)))
        for lo in range(0, n_leaves, per)]
    assert all(f["n"] * f["n_leaves"] <= MAX_PTRS for f in folds)


def tree_case(rng, hidden=8):
    cfg = SolarLSTMConfig(hidden_size=hidden)
    fc = SolarForecaster(cfg)
    tree = fc.init(torch.Generator().manual_seed(0), "cpu")
    return lambda: {k: ({kk: t32(rng.standard_normal(vv.shape))
                         for kk, vv in v.items()} if isinstance(v, dict)
                        else t32(rng.standard_normal(v.shape)))
                    for k, v in tree.items()}


@pytest.mark.parametrize("n", [1, 2, 3, 70, 128])
def test_fold_by_leaves_plain_matches_jax(n, rng):
    draw = tree_case(rng)
    trees = [draw() for _ in range(n)]
    ws = rng.dirichlet(np.ones(n)).tolist()
    if n > 1:
        ws[-1] = 0.0                      # a zero padding weight
    sets, pws = _pad_pow2(trees, ws)
    got = aggregate_pytrees(sets, pws)
    want = jax_agg_trees([jax.tree.map(jnp.asarray, {
        k: (v.numpy() if not isinstance(v, dict) else
            {kk: vv.numpy() for kk, vv in v.items()})
        for k, v in t.items()}) for t in sets], pws)
    assert list(got) == list(trees[0])                 # the port's key order
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    flat = aggregate_flat(torch.stack([flatten_params(t) for t in sets]),
                          pws)
    assert torch.equal(flatten_params(got), flat)      # same sums as a stack


def emulated_route(monkeypatch):
    """Send CPU tensors down the CUDA route of ``aggregate_leaves`` with a
    Python stand-in for the launch that reads the pointer tables."""
    tensors = {}
    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        tensors[t.data_ptr()] = t
        return t

    def launch(fold, device):
        def at(ptr, n):
            for base, t in tensors.items():
                off = (ptr - base) // 4
                if 0 <= off and off + n <= t.numel():
                    return t.reshape(-1)[off:off + n]
            raise AssertionError(f"pointer {ptr} is no leaf")
        nl = fold["n_leaves"]
        for l in range(nl):
            m = fold["len"][l]
            acc = torch.zeros(m)
            for i in range(fold["n"]):
                acc = acc + at(fold["x"][i * nl + l], m) * torch.tensor(
                    fold["w"][i], dtype=torch.float32)
            at(fold["out"][l], m).copy_(acc)
        agg_ops.launches += 1
        agg_ops.launches_leaves += 1

    monkeypatch.setattr(build, "on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(agg_ops, "_launch_leaves", launch)
    monkeypatch.setattr(agg_ops.torch, "empty", empty)
    return tensors


@pytest.mark.parametrize("n", [2, 3, 64, 70, 128])
def test_fold_by_leaves_tables_read_the_leaves_in_order(n, rng, monkeypatch):
    """The CUDA route's pointer tables, read back on the CPU: the same sums
    as the plain fold, in one launch up to 64 sets."""
    draw = tree_case(rng)
    trees = [draw() for _ in range(n)]
    ws = rng.dirichlet(np.ones(n)).tolist()
    want = agg_leaves_ref([tree_leaves(t) for t in trees], ws)
    tensors = emulated_route(monkeypatch)
    for t in trees:
        for x in tree_leaves(t):
            tensors[x.data_ptr()] = x
    reset_launch_counts()
    got = aggregate_pytrees(trees, ws)
    assert agg_ops.launches_leaves == 1 + max(0, -(-(n - MAX_N) // (MAX_N - 1)))
    torch.testing.assert_close(flatten_params(got), want, rtol=0, atol=1e-6)

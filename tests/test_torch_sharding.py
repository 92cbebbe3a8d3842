"""The port's mesh rules, cache specs and DTensor placements against the
JAX package, on the CPU.

Spec trees are compared as tuples: the port's ``PartitionSpec`` is a tuple
whose entries are a mesh-axis name, a tuple of names or None, so
``tuple(port) == tuple(jax)`` for every leaf of every config's parameters
and decode caches, under the 16x16, the multi-pod 2x16x16, the decode
override ``kv_seq="data"`` and a (1, 1) mesh's rules (the port's read off a
``DeviceMesh``; the reference's off the same axis sizes).  Placements are
checked on a fake 512-rank mesh with meta tensors (no storage): each local
shard's shape is the global shape divided as the spec says.  Model runs on
a (1, 1) gloo mesh equal the plain forward exactly; a spawned 2-process
gloo world holds attention (GQA, heads sharded over "model"), the chunked
SSD (heads and groups sharded), the model's attention with query heads
that do not divide "model" (replicated, as the reference's rules place
them: no ``mesh_ops`` gather under a ``CollectiveCounter``) and the
DTensor einsum against the unsharded results within 1e-6 (f32 sums split
over two ranks).  Every test
that starts a process group destroys it, also when it fails.
"""

import os
import socket
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serving.kv_cache import cache_shapes as jax_cache_shapes
from repro.serving.kv_cache import cache_specs as jax_cache_specs
from repro.sharding.logical import Rules as JaxRules
from repro.sharding.logical import make_rules as jax_make_rules
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config, reduced_for_smoke
from repro_torch.data.lm_synth import lm_batch
from repro_torch.launch.mesh import fake_world, host_world
from repro_torch.models.model import build_model
from repro_torch.serving.kv_cache import cache_shapes, cache_specs
from repro_torch.sharding.logical import (
    DEFAULT_RULES,
    MULTI_POD_RULES,
    P,
    ParamSpec,
    Rules,
    constrain,
    distribute,
    logical_to_spec,
    make_rules,
    on_mesh,
    placements,
    shardings_from_schema,
    specs_from_schema,
    stack_schema,
)

RULE_SETS = {
    "16x16": ((16, 16), ("data", "model"), {}, False),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), {}, True),
    "decode_kv_seq": ((16, 16), ("data", "model"), {"kv_seq": "data"}, False),
    "1x1": ((1, 1), ("data", "model"), {}, False),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_rules(name) -> Rules:
    """The rule set read off a ``DeviceMesh`` of its shape (a fake world of
    that many ranks, destroyed before returning)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes, overrides, multi_pod = RULE_SETS[name]
    with fake_world(int(np.prod(shape))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        return make_rules(mesh, multi_pod=multi_pod, **overrides)


def jax_rules(name) -> JaxRules:
    shape, axes, overrides, multi_pod = RULE_SETS[name]
    fake_mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    return jax_make_rules(fake_mesh, multi_pod=multi_pod, **overrides)


@pytest.fixture(scope="module")
def rule_pairs():
    return {name: (port_rules(name), jax_rules(name)) for name in RULE_SETS}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"".join(f"/{p.key}" for p in path): leaf for path, leaf in leaves}


def test_the_archs_line_up():
    assert tuple(ALL_ARCHS) == tuple(JAX_ARCHS)
    assert set(INPUT_SHAPES) == set(JAX_SHAPES)


@pytest.mark.parametrize("rules_name", list(RULE_SETS))
def test_rules_equal_jax(rules_name, rule_pairs):
    port, ref = rule_pairs[rules_name]
    assert port.axes == ref.axes
    assert port.sizes == ref.sizes


@pytest.mark.parametrize("rules_name", list(RULE_SETS))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_jax(arch, rules_name, rule_pairs):
    port, ref = rule_pairs[rules_name]
    got = flat(build_model(get_config(arch)).param_specs(port))
    want = jax_flat(jax_build_model(jax_get_config(arch)).param_specs(ref))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert isinstance(spec, P)
        assert tuple(spec) == tuple(want[path]), path


DECODERS = [a for a in ALL_ARCHS if get_config(a).supports_decode]


@pytest.mark.parametrize("rules_name", ["16x16", "decode_kv_seq", "1x1"])
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_equal_jax(arch, rules_name, rule_pairs):
    port, ref = rule_pairs[rules_name]
    cfg = get_config(arch)
    shape = INPUT_SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    shapes = cache_shapes(build_model(cfg), B, S, torch.bfloat16)
    jshapes = jax_cache_shapes(jax_build_model(jax_get_config(arch)), B, S,
                               jnp.bfloat16)
    got, want = flat(cache_specs(shapes, port)), jax_flat(
        jax_cache_specs(jshapes, ref))
    shapes_flat = flat(shapes)
    jshapes_flat = {k: v for k, v in jax_flat(jshapes).items()}
    assert set(got) == set(want)
    for path, spec in got.items():
        assert shapes_flat[path].device.type == "meta"
        assert tuple(shapes_flat[path].shape) == tuple(jshapes_flat[path].shape)
        assert tuple(spec) == tuple(want[path]), path


# --------------------------- tests/test_checkpoint_sharding.py's, ported
def fake_rules(sizes=None):
    return Rules(axes=make_rules().axes, sizes=sizes or {"data": 16, "model": 16})


def test_divisibility_guard():
    rules = fake_rules()
    # kv_heads=2 not divisible by model=16 -> replicated
    spec = logical_to_spec(("embed", "kv_heads", "head_dim"), rules,
                           (4096, 2, 128))
    assert spec == P("data")
    # kv_heads=32 divisible -> sharded
    spec = logical_to_spec(("embed", "kv_heads", "head_dim"), rules,
                           (4096, 32, 128))
    assert spec == P("data", "model")


def test_duplicate_mesh_axis_dropped():
    rules = fake_rules()
    # batch takes "data"; embed (also data-mapped) must fall back to None
    spec = logical_to_spec(("batch", "seq", "embed"), rules, (256, 4096, 4096))
    assert spec == P("data")


def test_multi_pod_batch_spans_pod_and_data():
    rules = make_rules(multi_pod=True)
    rules = Rules(rules.axes, {"pod": 2, "data": 16, "model": 16})
    spec = logical_to_spec(("batch", "seq"), rules, (256, 4096))
    assert spec == P(("pod", "data"))
    assert MULTI_POD_RULES.axes["batch"] == ("pod", "data")
    assert DEFAULT_RULES.axes["batch"] == "data"


def test_stack_schema_adds_layer_axis():
    sch = {"w": ParamSpec((4, 8), ("embed", "mlp"))}
    st = stack_schema(sch, 12)
    assert st["w"].shape == (12, 4, 8)
    assert st["w"].logical[0] == "layers"


def test_specs_from_schema_tree():
    rules = fake_rules()
    sch = {"layer": {"w": ParamSpec((64, 32), ("embed", "mlp")),
                     "scale": ParamSpec((64,), ("embed",))}}
    specs = specs_from_schema(sch, rules)
    assert specs["layer"]["w"] == P("data", "model")
    assert specs["layer"]["scale"] == P("data")


def test_cache_specs_by_name():
    rules = Rules(make_rules(kv_seq="data").axes, {"data": 16, "model": 16})
    meta = torch.empty((8, 2, 32768, 16, 128), dtype=torch.bfloat16,
                       device="meta")
    tree = {"seg0": {"b0": {"k": meta, "v": meta}}}
    specs = cache_specs(tree, rules)
    # layers, batch(2: not div by 16 -> None), kv_seq->data, kv_heads 16->model
    assert specs["seg0"]["b0"]["k"] == P(None, None, "data", "model")
    assert cache_specs({"x": torch.empty((3,), device="meta")}, rules)["x"] == P()


# ------------------------------------------------------------- the port's
def test_param_spec_checks_its_rank():
    with pytest.raises(ValueError, match="rank"):
        ParamSpec((4, 8), ("embed",))
    ParamSpec((4, 8), ("embed", "mlp"))


def test_partition_spec_is_a_tuple():
    spec = P("data", ("pod", "data"), None)
    assert tuple(spec) == tuple(JP("data", ("pod", "data"), None))
    assert isinstance(spec, tuple) and len(spec) == 3


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-7b", "mamba2-370m"])
def test_placements_shard_as_the_spec_says(arch):
    """Every parameter of ``arch`` distributed (meta shards) on a fake
    (2, 16, 16) mesh by the multi-pod rules: each local shard is the global
    shape divided along each dim by the extent of the mesh axes its spec
    entry names."""
    from torch.distributed.device_mesh import init_device_mesh

    model = build_model(get_config(arch))
    with fake_world(512):
        mesh = init_device_mesh("cpu", (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
        rules = make_rules(mesh, multi_pod=True)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        specs = flat(model.param_specs(rules))
        placed = flat(distribute(model.param_shapes(), mesh,
                                 shardings_from_schema(model.schema(), mesh,
                                                       rules)))
        n_sharded = 0
        for path, x in placed.items():
            want = list(x.shape)
            for d, entry in enumerate(specs[path]):
                for a in (() if entry is None else
                          (entry,) if isinstance(entry, str) else entry):
                    want[d] //= sizes[a]
                    n_sharded += 1
            assert list(x.to_local().shape) == want, path
    assert n_sharded > 0


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 size=lambda i: (2, 16, 16)[i])
    assert placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(P("expert"), mesh)
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                size=lambda i: 1)
    assert placements(P("data", "model"), one) == (Replicate(), Replicate())


def test_constrain_is_the_identity_off_the_mesh():
    x = torch.ones(2, 3)
    assert constrain(x, ("batch", "seq"), None) is x
    assert constrain(x, ("batch", "seq"), fake_rules()) is x


@pytest.mark.parametrize("kv", [2, 8])
def test_gqa_attention_trains_on_a_fake_multi_pod_mesh(kv):
    """The attention layer's forward and backward on meta DTensors placed
    by the multi-pod rules on a fake (2, 16, 16) world, with 32 query
    heads (sharded over the 16-wide "model" axis) and K/V heads that do
    not divide it: the gradient of the (kv, g) -> heads merge comes back
    in the merged layout, so its view splits (DTensor would otherwise
    hand it back sharded over heads, which 2 or 8 kv heads cannot
    take).  Every gradient has its parameter's shape and settles to its
    placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.attention import attention_forward, attention_schema
    from repro_torch.sharding.logical import schema_shapes

    cfg = get_config("glm4-9b").replace(d_model=512, n_heads=32,
                                        n_kv_heads=kv, head_dim=16)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        rules = make_rules(mesh, multi_pod=True)
        schema = attention_schema(cfg)
        pls = shardings_from_schema(schema, mesh, rules)
        p = distribute({k: v.to("meta").requires_grad_() for k, v in
                        schema_shapes(schema, torch.bfloat16).items()},
                       mesh, pls)
        shape = (64, 8, cfg.d_model)
        x = distribute_tensor(
            torch.empty(shape, dtype=torch.bfloat16, device="meta"), mesh,
            placements(logical_to_spec(("batch", "seq", "act_embed"), rules,
                                       shape), mesh), src_data_rank=None)
        with on_mesh():
            y, _ = attention_forward(cfg, p, x, causal=True, window=0,
                                     positions=torch.arange(8, device="meta"),
                                     rules=rules)
            grads = torch.autograd.grad(y.sum(), list(p.values()))
            for (k, w), g in zip(p.items(), grads, strict=True):
                # pending sums over the batch shards settle to the
                # parameter's own layout
                g = g.redistribute(mesh, pls[k])
                assert g.shape == w.shape and g.placements == pls[k], k
    assert not dist.is_initialized()


@pytest.mark.parametrize("rules_kw", [{}, {"seq": "model"}])
def test_forward_on_a_one_rank_mesh_equals_the_plain_forward(rules_kw):
    """``tests/test_perf_features.py``'s sequence-parallel rules
    (``make_rules(seq="model")``) and the mesh's own: reduced deepseek-7b
    with its parameters and tokens distributed on a (1, 1) gloo mesh gives
    the plain forward's logits exactly."""
    from torch.distributed.tensor import distribute_tensor

    cfg = reduced_for_smoke(get_config("deepseek-7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(lm_batch(np.random.default_rng(0), 2, 16,
                                    cfg.vocab_size)["tokens"])
    base, _ = model.forward(params, tokens=toks)
    with host_world("cpu") as mesh:
        rules = make_rules(seq="model") if rules_kw else make_rules(mesh)
        placed = distribute(params, mesh, shardings_from_schema(
            model.schema(), mesh, make_rules(mesh)))
        dtoks = distribute_tensor(toks, mesh, placements(logical_to_spec(
            ("batch", "seq"), make_rules(mesh), tuple(toks.shape)), mesh))
        with on_mesh():
            out, _ = model.forward(placed, tokens=dtoks, rules=rules)
        assert torch.equal(out.full_tensor(), base)
    assert not dist.is_initialized()


# ---------------------------------------------------- two ranks, spawned
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_worker(rank, port, out_dir):
    """One rank of a (1, 2) ("data", "model") gloo mesh: attention with
    GQA (heads 4 over kv 2, and kv 1, which cannot shard), the model's
    attention layer with its parameters placed by the rules (reduced
    gemma-2b, kv 1; glm4-9b, kv 2), the chunked SSD (heads 4 over groups
    2) and the einsum, each on DTensors sharded over "model" against the
    plain call; forward and gradients."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.local_attn.ops import local_flash_attention
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_fused
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.models.attention import attention_forward, attention_schema
    from repro_torch.models.layers import einsum
    from repro_torch.sharding.logical import init_from_schema

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    errs = {}
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)

        def put(x, pl):
            return distribute_tensor(x.detach().clone().requires_grad_(),
                                     mesh, pl)

        for kv in (2, 1):
            q = torch.randn(2, 4, 24, 16, generator=g)
            k = torch.randn(2, kv, 24, 16, generator=g)
            v = torch.randn(2, kv, 24, 16, generator=g)
            dout = torch.randn(2, 4, 24, 16, generator=g)
            qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
            want = local_flash_attention(qs, ks, vs, causal=True, window=8,
                                         scale=0.25)
            want.backward(dout)
            pl_k = [Replicate(), Shard(1) if kv % 2 == 0 else Replicate()]
            dq, dk, dv = (put(q, [Replicate(), Shard(1)]), put(k, pl_k),
                          put(v, pl_k))
            got = local_flash_attention(dq, dk, dv, causal=True, window=8,
                                        scale=0.25)
            got.backward(distribute_tensor(dout, mesh, got.placements))
            errs[f"attn_kv{kv}"] = max(
                (got.full_tensor() - want).abs().max().item(),
                *((a.grad.full_tensor() - b.grad).abs().max().item()
                  for a, b in ((dq, qs), (dk, ks), (dv, vs))))
            errs[f"attn_kv{kv}_heads_sharded"] = float(
                got.placements[1] == Shard(1))

        x = torch.randn(2, 20, 4, 8, generator=g)
        dt = torch.rand(2, 20, 4, generator=g) * 0.5
        A = -torch.rand(4, generator=g)
        B = torch.randn(2, 20, 2, 6, generator=g)
        C = torch.randn(2, 20, 2, 6, generator=g)
        y, state = ssd_chunked_fused(x, dt, A, B, C, 8)
        ys, ss = ssd_chunked_fused(
            put(x, [Replicate(), Shard(2)]), put(dt, [Replicate(), Shard(2)]),
            put(A, [Replicate(), Shard(0)]), put(B, [Replicate(), Shard(2)]),
            put(C, [Replicate(), Shard(2)]), 8)
        errs["ssd"] = max((ys.full_tensor() - y).abs().max().item(),
                          (ss.full_tensor() - state).abs().max().item())

        # the model's attention with its parameters placed by the rules:
        # heads 4 over "model", kv heads 1 (replicated: q gathered before
        # the GQA split) and 2 (sharded with q); forward and gradients
        for arch in ("gemma-2b", "glm4-9b"):
            cfg = reduced_for_smoke(get_config(arch))
            rules = make_rules(mesh)
            schema = attention_schema(cfg)
            p = init_from_schema(schema, g, "cpu")
            x = torch.randn(2, 12, cfg.d_model, generator=g)
            dy = torch.randn(2, 12, cfg.d_model, generator=g)
            pos = torch.arange(12)
            kw = dict(positions=pos, window=0, causal=True)
            live = {k: t.clone().requires_grad_() for k, t in p.items()}
            xs = x.clone().requires_grad_()
            want, _ = attention_forward(cfg, live, xs, **kw)
            want.backward(dy)
            pls = shardings_from_schema(schema, mesh, rules)
            dp = {k: put(t, pls[k]) for k, t in p.items()}
            dx = put(x, [Replicate(), Replicate()])
            with on_mesh():
                got, _ = attention_forward(cfg, dp, dx, rules=rules, **kw)
                got.backward(distribute_tensor(dy, mesh, got.placements))
            # relative to max(1, max|plain|): the contractions sum the
            # sharded heads in another order
            errs[f"attention_{arch}"] = max(
                (a.full_tensor() - b).abs().max().item()
                / max(1.0, b.abs().max().item())
                for a, b in ((got, want), (dx.grad, xs.grad),
                             *((dp[k].grad, live[k].grad) for k in p)))
            errs[f"attention_{arch}_kv_heads_sharded"] = float(
                dp["wk"].placements[1] == Shard(1))

        # query heads that do not divide the model extent (3 over 2): the
        # rules replicate them and their kv heads, as the reference's do;
        # the activations shard batch (kv 1) or the contracted d (kv 3)
        # over "model", so every projection goes through mesh_ops' placed
        # bmm, and no collective of the run is a mesh_ops gather
        for kv, xdim in ((1, 0), (3, 2)):
            cfg = reduced_for_smoke(get_config("gemma-2b")).replace(
                n_heads=3, n_kv_heads=kv)
            rules = make_rules(mesh)
            schema = attention_schema(cfg)
            p = init_from_schema(schema, g, "cpu")
            x = torch.randn(2, 12, cfg.d_model, generator=g)
            dy = torch.randn(2, 12, cfg.d_model, generator=g)
            kw = dict(positions=torch.arange(12), window=0, causal=True)
            live = {k: t.clone().requires_grad_() for k, t in p.items()}
            xs = x.clone().requires_grad_()
            want, _ = attention_forward(cfg, live, xs, **kw)
            want.backward(dy)
            pls = shardings_from_schema(schema, mesh, rules)
            dp = {k: put(t, pls[k]) for k, t in p.items()}
            dx = put(x, [Replicate(), Shard(xdim)])
            counter = CollectiveCounter()
            with counter, on_mesh():
                got, _ = attention_forward(cfg, dp, dx, rules=rules, **kw)
                got.backward(distribute_tensor(dy, mesh, got.placements))
            tag = f"attention_heads3_kv{kv}"
            errs[tag] = max(
                (a.full_tensor() - b).abs().max().item()
                / max(1.0, b.abs().max().item())
                for a, b in ((got, want), (dx.grad, xs.grad),
                             *((dp[k].grad, live[k].grad) for k in p)))
            errs[f"{tag}_heads_sharded"] = float(
                dp["wq"].placements[1] == Shard(1))
            errs[f"{tag}_fallback_collectives"] = float(
                sum(counter.fallback_counts.values()))

        a = torch.randn(2, 3, 8, generator=g)
        w = torch.randn(8, 4, 6, generator=g)
        want = torch.einsum("bsd,dhk->bshk", a, w)
        got = einsum("bsd,dhk->bshk", put(a, [Replicate(), Shard(2)]),
                     put(w, [Replicate(), Shard(0)]))
        errs["einsum"] = (got.full_tensor() - want).abs().max().item()
    finally:
        dist.destroy_process_group()
    torch.save(errs, os.path.join(out_dir, f"rank{rank}.pt"))


def test_sharded_kernels_equal_the_unsharded_on_two_ranks(tmp_path):
    import torch.multiprocessing as mp

    env = dict(OMP_NUM_THREADS="1")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ranks = mp.start_processes(
            _two_rank_worker, args=(_free_port(), str(tmp_path)), nprocs=2,
            join=False, start_method="spawn")
        # a deadline of the test's own: ranks that hang are killed and the
        # test fails, instead of the join holding the run
        deadline = time.monotonic() + 150.0
        while not ranks.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ranks.processes:
                    proc.kill()
                pytest.fail("the two ranks missed the test's 150 s deadline")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for rank in range(2):
        errs = torch.load(tmp_path / f"rank{rank}.pt")
        assert errs["attn_kv2_heads_sharded"] == 1.0
        assert errs["attn_kv1_heads_sharded"] == 0.0
        assert errs["attention_glm4-9b_kv_heads_sharded"] == 1.0
        assert errs["attention_gemma-2b_kv_heads_sharded"] == 0.0
        for kv in (1, 3):
            assert errs[f"attention_heads3_kv{kv}_heads_sharded"] == 0.0
            assert errs[f"attention_heads3_kv{kv}_fallback_collectives"] == 0
        for name, err in errs.items():
            if not name.endswith("heads_sharded"):
                assert err <= 1e-6, (rank, name, err)

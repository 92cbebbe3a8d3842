"""The port's dry-run against the JAX package's, on the CPU.

``input_specs`` gives the reference's keys, shapes and dtypes as meta
tensors for every family.  One (arch, shape) runs end to end in a
subprocess on a fake 256-rank world (gemma-2b ``decode_32k`` at 16x16, a
few seconds): status ok, its ``analytic`` record equal to the
reference's ``analytic_costs`` for the same arguments, its collectives
recorded from DTensor (the plan's in the roofline, ``mesh_ops``' gathers
apart).  Training steps of configs whose query or kv heads do not divide
the 16-wide "model" axis (gemma-2b, glm4-9b) or whose gradients arrive
in a permuted layout (hubert-xlarge) issue no ``mesh_ops`` gather: the
reference's rules keep such heads replicated (ROADMAP.md §3).  The
reference's two subprocess tests (mamba2-370m
``train_4k --multi-pod``) and the cluster-parallel mode are ``heavy``, as
the reference's are.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import dryrun as jax_dryrun
from repro.launch.roofline import analytic_costs as jax_analytic_costs
from repro_torch.configs import (
    ALL_ARCHS,
    INPUT_SHAPES,
    get_config,
    reduced_for_smoke,
)
from repro_torch.data.lm_synth import lm_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import host_world
from repro_torch.models.model import build_model
from repro_torch.models.moe import expert_counts
from repro_torch.sharding.logical import (
    distribute,
    logical_to_spec,
    make_rules,
    on_mesh,
    placements,
    shardings_from_schema,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32,
           torch.bool: jnp.bool_}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_cover_all_families(shape):
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        sds, logical = dryrun.input_specs(cfg, INPUT_SHAPES[shape])
        jsds, jlogical = jax_dryrun.input_specs(jax_get_config(arch),
                                                JAX_SHAPES[shape])
        assert set(sds) == set(logical) == set(jsds)
        assert logical == jlogical
        for k, s in sds.items():
            assert s.device.type == "meta"
            assert tuple(s.shape) == tuple(jsds[k].shape), (arch, k)
            assert _DTYPES[s.dtype] == jsds[k].dtype, (arch, k)
            assert s.shape[0] == INPUT_SHAPES[shape].global_batch


def run_dryrun(*args, timeout=540):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dryrun_subprocess_decode_single_pod():
    rec = run_dryrun("--arch", "gemma-2b", "--shape", "decode_32k", timeout=120)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    want = jax_analytic_costs(jax_get_config("gemma-2b"),
                              JAX_SHAPES["decode_32k"], 256,
                              {"data": 16, "model": 16}, remat="none",
                              moment_bytes=4, window_override=None,
                              mla_absorb=True)
    assert rec["analytic"] == want
    assert rec["roofline"]["compute_s"] > 0
    coll = rec["collectives"]
    assert coll["total"] > 0 and sum(coll["counts"].values()) > 0
    assert coll["total"] == sum(coll["by_kind"].values())
    assert rec["roofline"]["collective_bytes_per_dev"] == coll["total"]
    fb = coll["fallback"]
    assert set(fb) == {"total", "by_kind", "counts"}
    assert fb["total"] == sum(fb["by_kind"].values())
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["note"]
    assert "hlo_raw_cost" not in rec


@pytest.mark.parametrize("arch,shape,timeout", [
    ("deepseek-moe-16b", "long_500k", 120),
    ("deepseek-v3-671b", "decode_32k", 180),
])
def test_dryrun_subprocess_moe_routes_on_the_mesh(arch, shape, timeout):
    rec = run_dryrun("--arch", arch, "--shape", shape, timeout=timeout)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    jcfg = jax_get_config(arch)
    want = jax_analytic_costs(
        jcfg, JAX_SHAPES[shape], 256, {"data": 16, "model": 16},
        remat="none", moment_bytes=4,
        window_override=jcfg.long_context_window if shape == "long_500k"
        else None, mla_absorb=True)
    assert rec["analytic"] == want
    assert rec["roofline"]["compute_s"] > 0


@pytest.mark.parametrize("arch", ["gemma-2b", "glm4-9b", "hubert-xlarge"])
def test_dryrun_subprocess_train_gathers_only_what_the_plan_gathers(arch):
    rec = run_dryrun("--arch", arch, "--shape", "train_4k", timeout=300)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    fb = rec["collectives"]["fallback"]
    assert fb["total"] == 0 and sum(fb["counts"].values()) == 0, fb
    assert rec["collectives"]["total"] > 0
    jcfg = jax_get_config(arch).replace(remat=rec["remat"])
    want = jax_analytic_costs(jcfg, JAX_SHAPES["train_4k"], 256,
                              {"data": 16, "model": 16}, remat=rec["remat"],
                              moment_bytes=4, window_override=None,
                              mla_absorb=rec["mla_absorb"])
    assert rec["analytic"] == want


@pytest.mark.parametrize("n,experts", [(0, 4), (1, 4), (96, 16), (4096, 64)])
def test_expert_counts_equal_bincount(n, experts):
    """The router's count on a mesh, a scatter_add of ones, is
    ``torch.bincount(...).float()`` bit for bit (experts drawn or not), and
    runs on meta tensors, which bincount cannot."""
    ids = torch.from_numpy(np.random.default_rng(n).integers(
        0, max(1, experts // 2), n)).long()
    got = expert_counts(ids, experts)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bincount(ids, minlength=experts).float())
    meta = expert_counts(ids.to("meta"), experts)
    assert meta.shape == (experts,) and meta.device.type == "meta"


def test_moe_forward_on_a_one_rank_mesh_equals_the_plain_forward():
    """Reduced deepseek-moe-16b with its parameters and tokens distributed
    on a (1, 1) gloo mesh: the router's bookkeeping runs under local_map
    on DTensor ids, and the logits equal the plain forward's exactly."""
    from torch.distributed.tensor import distribute_tensor

    cfg = reduced_for_smoke(get_config("deepseek-moe-16b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(lm_batch(np.random.default_rng(0), 2, 16,
                                    cfg.vocab_size)["tokens"])
    base, _ = model.forward(params, tokens=toks)
    with host_world("cpu") as mesh:
        rules = make_rules(mesh)
        placed = distribute(params, mesh, shardings_from_schema(
            model.schema(), mesh, rules))
        dtoks = distribute_tensor(toks, mesh, placements(logical_to_spec(
            ("batch", "seq"), rules, tuple(toks.shape)), mesh))
        with on_mesh():
            out, _ = model.forward(placed, tokens=dtoks, rules=rules)
        assert torch.equal(out.full_tensor(), base)


def test_encoder_only_decode_is_skipped():
    rec = dryrun.run_one("hubert-xlarge", "decode_32k", verbose=False)
    assert rec["status"] == "skipped" and rec["reason"]


@pytest.mark.heavy
def test_dryrun_subprocess_single_pod():
    rec = run_dryrun("--arch", "gemma-2b", "--shape", "train_4k")
    assert rec["status"] == "ok"
    assert rec["roofline"]["compute_s"] > 0


@pytest.mark.heavy
def test_dryrun_subprocess_multi_pod():
    rec = run_dryrun("--arch", "mamba2-370m", "--shape", "train_4k",
                     "--multi-pod")
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"


@pytest.mark.heavy
def test_dryrun_subprocess_cluster_parallel():
    rec = run_dryrun("--arch", "mamba2-370m", "--shape", "train_4k",
                     "--cluster-parallel")
    assert rec["status"] == "ok" and rec["n_clusters"] == 2
    assert rec["collectives"]["by_kind"]["all-reduce"] > 0

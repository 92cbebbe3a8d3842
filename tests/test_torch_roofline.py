"""The port's roofline model against the JAX package's, on the CPU.

``analytic_costs`` and ``model_flops`` are the reference's closed forms
over the config, copied: their dicts must equal the reference's exactly for
every architecture, every applicable input shape, MLA absorbed and naive,
on the 256-rank (16, 16) and the 512-rank (2, 16, 16) mesh, both moment
widths.  ``roofline_terms`` divides by the H100's peaks.  The collective
counter reads a hand-built DTensor program on a fake mesh whose all-gather
and all-reduce bytes are known (the counterpart of the reference's
``test_collective_parse_basic``, HLO there, DTensor here).
"""

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import shape_is_applicable as jax_applicable
from repro.launch import roofline as jax_roofline
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import fake_world

MESHES = {"256": (256, {"data": 16, "model": 16}),
          "512": (512, {"pod": 2, "data": 16, "model": 16})}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_model_equals_jax(arch, mesh):
    n_chips, sizes = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n = 0
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        ok, _ = jax_applicable(jcfg, jshape)
        if not ok:
            continue
        for absorb in (True, False):
            for moment_bytes in (4, 2):
                kw = dict(remat="full" if shape.mode == "train" else "none",
                          moment_bytes=moment_bytes, mla_absorb=absorb,
                          window_override=(cfg.long_context_window
                                           if name == "long_500k" else None))
                got = roofline.analytic_costs(cfg, shape, n_chips, sizes, **kw)
                want = jax_roofline.analytic_costs(jcfg, jshape, n_chips,
                                                   sizes, **kw)
                assert got == want, (name, absorb, moment_bytes)
                n += 1
        assert roofline.model_flops(cfg, shape, cfg.n_params(),
                                    cfg.n_active_params()) == \
            jax_roofline.model_flops(jcfg, jshape, jcfg.n_params(),
                                     jcfg.n_active_params())
        assert roofline.forward_flops_per_token(cfg, 1024.0) == \
            jax_roofline.forward_flops_per_token(jcfg, 1024.0)
    assert n > 0


def test_h100_peaks():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


def test_roofline_terms_dominance():
    t = roofline.roofline_terms(
        {"flops": roofline.PEAK_FLOPS, "bytes accessed": roofline.HBM_BW * 2},
        {"total": roofline.LINK_BW * 0.5})
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant == "memory"
    d = t.as_dict()
    assert d["dominant"] == "memory" and d["flops_per_dev"] == roofline.PEAK_FLOPS


def test_analytic_mla_absorb_gap():
    """The analytic roofline must show the naive-MLA decode blowup."""
    cfg = get_config("deepseek-v3-671b")
    shp = INPUT_SHAPES["decode_32k"]
    mesh = {"data": 16, "model": 16}
    absorbed = roofline.analytic_costs(cfg, shp, 256, mesh, mla_absorb=True)
    naive = roofline.analytic_costs(cfg, shp, 256, mesh, mla_absorb=False)
    assert naive["flops_per_dev"] > 50 * absorbed["flops_per_dev"]


def test_collective_counter_basic():
    """An all-gather of a bf16 (2048, 512) tensor sharded 16 ways and an
    all-reduce of a partial f32 (256,) vector: result-shape bytes, the
    all-reduce counted twice (ring), one of each."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(2048, 512, dtype=torch.bfloat16,
                                          device="meta"),
                              mesh, [Shard(0), Replicate()], src_data_rank=None)
        y = DTensor.from_local(torch.empty(256, device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)

        def program():
            return (x.redistribute(mesh, [Replicate(), Replicate()]),
                    y.redistribute(mesh, [Replicate(), Replicate()]))

        (a, b), c = roofline.collective_bytes(program)
    assert a.to_local().shape == (2048, 512) and b.to_local().shape == (256,)
    assert c["counts"]["all-gather"] == 1 and c["counts"]["all-reduce"] == 1
    assert c["by_kind"]["all-gather"] == 2048 * 512 * 2
    assert c["by_kind"]["all-reduce"] == 256 * 4 * 2      # 2x for ring
    assert c["total"] == c["by_kind"]["all-gather"] + c["by_kind"]["all-reduce"]
    assert set(c["by_kind"]) == set(jax_roofline._COLLECTIVES)
    assert c["scan_trip"] == 1


def test_collective_counter_sees_nothing_on_plain_tensors():
    out, c = roofline.collective_bytes(lambda: torch.ones(4) * 2)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert c["total"] == 0 and sum(c["counts"].values()) == 0


def test_collective_counter_files_mesh_ops_gathers_apart():
    """A view DTensor refuses (a dim of 64 sharded 16 ways split into
    8 x 8) goes through ``mesh_ops``' gather: its all-gather is reported
    under ``fallback``, not in the plan's ``total``; a redistribution the
    caller asks for is the plan's."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.sharding import mesh_ops

    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(256, 64, dtype=torch.bfloat16,
                                          device="meta"),
                              mesh, [Shard(0), Shard(1)], src_data_rank=None)

        def program():
            planned = x.redistribute(mesh, [Replicate(), Shard(1)])
            return planned, mesh_ops._reshape(x, (256, 8, 8))

        (p, y), c = roofline.collective_bytes(program)
    assert tuple(y.shape) == (256, 8, 8)
    assert y.placements == (Shard(0), Replicate()) and not mesh_ops.in_fallback()
    fb = c["fallback"]
    assert fb["counts"]["all-gather"] == 1 and fb["total"] == 16 * 64 * 2
    assert c["counts"]["all-gather"] == 1 and c["total"] == 256 * 4 * 2
    assert c["total"] == sum(c["by_kind"].values())

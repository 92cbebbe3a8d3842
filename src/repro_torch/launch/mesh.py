"""Production mesh definition, on ``torch.distributed``'s ``DeviceMesh``.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  512 ranks as (pod=2, data=16, model=16) -- the pod axis carries
FedCCL's cluster-parallel dimension (``core.cluster_parallel``).

A mesh needs a default process group of its size.  A real run starts one
process a GPU and its group (``torchrun``); the dry-run starts PyTorch's
fake group of 256 or 512 ranks in one process (``fake_world``); tests and
single-card runs use ``make_host_mesh``.  One default group is allowed a
process, so whoever starts one destroys it (``host_world``,
``fake_world``), also when what runs inside fails.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh over the default process group,
    which must hold exactly that many ranks: on the cards under nccl, on
    the CPU under any other backend (the dry-run's fake one)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_production_mesh: no default process group; start one of "
            f"{size} ranks (torchrun, or launch.mesh.fake_world({size}) for "
            "the dry-run)")
    if dist.get_world_size() != size:
        raise RuntimeError(
            f"make_production_mesh: the mesh {shape} needs {size} ranks, the "
            f"default group has {dist.get_world_size()}")
    device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """An (n, 1) ("data", "model") mesh over the visible devices: the CUDA
    cards (CUDA unless the caller says), or the CPU as one.  Where no
    default group exists this process starts a world of one rank over a
    ``HashStore`` (nccl on CUDA, gloo on the CPU); destroy it with
    ``dist.destroy_process_group()``, or use ``host_world``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"make_host_mesh: {n} cards need one process each; start them "
                "with torchrun")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_world(device=None):
    """``make_host_mesh`` in a world of its own, destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("host_world: a default process group exists")
    try:
        yield make_host_mesh(device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks in this one process, on
    PyTorch's fake backend: collectives return at once and move nothing.
    For planning a sharded run (``launch.dryrun``); destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()

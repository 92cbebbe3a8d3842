"""Logical-axis sharding (MaxText-style), on a ``DeviceMesh``.

Every parameter is declared once in a *schema*: shape + logical axis names +
init kind.  From the schema we derive (a) initialized params, (b) a
``PartitionSpec`` tree under a rule set mapping logical axes -> mesh axes,
(c) the DTensor placements of that spec on a ``DeviceMesh``.  Rules are
shape-aware: a mapping is dropped when the tensor dim is not divisible by
the mesh-axis size (e.g. kv_heads=2 over model=16 falls back to
replicated), so every (arch x shape x mesh) combination places.

Parameter sharding doubles as FSDP: the "embed" axis of weight matrices
maps to the "data" mesh axis, so parameters are fully sharded over the
whole mesh (ZeRO-3 style); DTensor gathers them where an op needs them.
Activations shard batch over "data" -- the duplicate-mesh-axis guard then
auto-drops "embed" for activations.

``PartitionSpec`` is the port's own: a tuple whose entries are a mesh-axis
name, a tuple of names, or None, so ``tuple(spec)`` equals ``tuple(P)`` of
the reference's spec.  ``placements`` turns one into DTensor placements.

Draws are made on the given ``torch.Generator``'s own device (a CUDA
generator fills a full-width model on the card), in schema order, then
cast and placed on the target device; they do not reproduce JAX's PRNG, so
parity runs pass JAX-initialised params through the weights bridge
(``utils.tree.params_from_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None)
_BASE_AXES: dict[str, object] = {
    "batch": "data",
    "seq": None,
    "embed": "data",          # FSDP axis for params; auto-dropped on activations
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "layers": None,
    "lru": "model",
    "ssm_inner": "model",
    "state": None,
    "conv": None,
    "rank": None,
    "cap": None,
    "kv_seq": None,
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (major
    to minor), or None (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Rules:
    axes: dict
    sizes: dict               # mesh axis -> size; empty means "don't check"

    def with_overrides(self, **kw) -> "Rules":
        ax = dict(self.axes)
        ax.update(kw)
        return Rules(ax, self.sizes)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def make_rules(mesh=None, *, multi_pod: bool = False, **overrides) -> Rules:
    axes = dict(_BASE_AXES)
    if multi_pod:
        axes["batch"] = ("pod", "data")
        axes["embed"] = ("pod", "data")   # FSDP over the full dcn+ici data extent
    axes.update(overrides)
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    return Rules(axes, sizes)


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # stddev override
    dtype: str | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec: shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")


def logical_to_spec(logical: tuple, rules: Rules,
                    shape: tuple | None = None) -> PartitionSpec:
    mesh_axes = []
    used: set = set()
    for i, name in enumerate(logical):
        ax = rules.axes.get(name) if name is not None else None
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            # keep only mesh axes not yet used by an earlier tensor dim
            flat = tuple(a for a in flat if a not in used)
            if shape is not None and flat:
                total = 1
                for a in flat:
                    total *= rules.sizes.get(a, 1)
                if total == 0 or shape[i] % max(total, 1) != 0:
                    flat = ()
            if flat:
                used.update(flat)
                ax = flat[0] if len(flat) == 1 else flat
            else:
                ax = None
        mesh_axes.append(ax)
    while mesh_axes and mesh_axes[-1] is None:
        mesh_axes.pop()
    return PartitionSpec(*mesh_axes)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where tensor dim ``d`` maps to that mesh axis, else
    ``Replicate()``.  A tuple entry shards one tensor dim over several mesh
    axes; DTensor orders such shards by mesh dim and JAX by tuple position,
    so a tuple out of mesh order raises rather than lay data out otherwise.
    A mesh dim of size 1 replicates: the same layout as one shard, and
    DTensor can view a replicated size-1 tensor dim, not a sharded one."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"placements: mesh axis {a!r} of {spec} "
                                 f"is not in the mesh {tuple(names)}")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"placements: {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in order:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def _init_leaf(ps: ParamSpec, generator: torch.Generator,
               default_dtype: torch.dtype) -> torch.Tensor:
    dtype = getattr(torch, ps.dtype) if ps.dtype else default_dtype
    shape = tuple(ps.shape)
    if ps.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if ps.init == "ones":
        return torch.ones(shape, dtype=dtype)
    if ps.init == "embed":
        std = ps.scale if ps.scale is not None else 1.0
    else:
        fan_in = (int(np.prod(shape[:-1])) if len(shape) >= 2
                  else max(1, shape[0] if shape else 1))
        std = ps.scale if ps.scale is not None else \
            1.0 / max(1.0, np.sqrt(fan_in))
    # drawn on the generator's own device: a CUDA generator fills a
    # multi-billion-parameter model on the card
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(dtype)


def init_from_schema(schema: dict, generator: torch.Generator, device,
                     default_dtype: torch.dtype = torch.float32) -> dict:
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    _init_leaf(v, generator, default_dtype).to(device))
                for k, v in node.items()}

    return go(schema)


def schema_shapes(schema: dict, default_dtype: torch.dtype = torch.float32) -> dict:
    """The schema as ``meta`` tensors: shapes and dtypes, no storage."""
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    torch.empty(tuple(v.shape), device="meta",
                                dtype=getattr(torch, v.dtype) if v.dtype
                                else default_dtype))
                for k, v in node.items()}

    return go(schema)


def kernel_split(x, *, batch: int, heads: int, counts: tuple) -> list:
    """How a kernel that runs shard by shard splits the DTensor ``x`` (the
    call's lead input): for each mesh dim, "batch" where ``x`` is sharded
    on its ``batch`` dim there, "heads" where it is sharded on its
    ``heads`` dim and every head count in ``counts`` (query and kv heads,
    heads and groups) divides by the mesh extent that shards heads, so
    local head j still meets its own kv head or group; else None (the
    kernel needs the whole dim there).  ``split_placements`` gives each
    argument's placements from it."""
    out, extent = [], 1
    for i, pl in enumerate(x.placements):
        n = x.device_mesh.size(i)
        if pl.is_shard(batch):
            out.append("batch")
        elif pl.is_shard(heads) and all(c % (extent * n) == 0 for c in counts):
            extent *= n
            out.append("heads")
        else:
            out.append(None)
    return out


def split_placements(split: list, *, batch: int | None,
                     heads: int | None) -> tuple:
    """An argument's placements under ``kernel_split``'s roles: its own
    ``batch`` and ``heads`` dims (None where it has none: replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {"batch": batch, "heads": heads}
    return tuple(Replicate() if role is None or dims[role] is None
                 else Shard(dims[role]) for role in split)


def specs_from_schema(schema: dict, rules: Rules) -> dict:
    def go(node):
        return {
            k: (go(v) if isinstance(v, dict) else
                logical_to_spec(v.logical, rules, v.shape))
            for k, v in node.items()
        }

    return go(schema)


def shardings_from_schema(schema: dict, mesh, rules: Rules) -> dict:
    """The tree of DTensor placements of every leaf on ``mesh``."""
    def go(node):
        return {
            k: (go(v) if isinstance(v, dict) else
                placements(logical_to_spec(v.logical, rules, v.shape), mesh))
            for k, v in node.items()
        }

    return go(schema)


def distribute(tree: dict, mesh, placement_tree: dict) -> dict:
    """``tree``'s tensors as DTensors on ``mesh`` by ``placement_tree``
    (``shardings_from_schema``'s).  Every rank passes the same global
    tensors; each keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return {k: (distribute(v, mesh, placement_tree[k]) if isinstance(v, dict)
                else distribute_tensor(v, mesh, placement_tree[k],
                                       src_data_rank=None))
            for k, v in tree.items()}


def stack_schema(schema: dict, n: int) -> dict:
    """Prepend a scanned 'layers' axis to every leaf (scan-over-layers).
    The initializer's fan-in of a stacked matrix then includes the layer
    axis (``prod(shape[:-1])``), as in the reference."""

    def go(node):
        return {
            k: (go(v) if isinstance(v, dict) else
                ParamSpec((n,) + tuple(v.shape), ("layers",) + tuple(v.logical),
                          v.init, v.scale, v.dtype))
            for k, v in node.items()
        }

    return go(schema)


def constrain(x, logical: tuple, rules: Rules | None):
    """Redistribute a DTensor to its logical axes' placements; the identity
    without rules and on a plain tensor."""
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    try:
        mesh = x.device_mesh
        return x.redistribute(mesh, placements(
            logical_to_spec(logical, rules, tuple(x.shape)), mesh))
    except (ValueError, RuntimeError):
        return x


def settle(x):
    """A DTensor's pending sums (``Partial``) reduced to ``Replicate``;
    anything else unchanged.  The loss's gold logit of a vocab-sharded
    row is one: DTensor's reduce-scatter of that masked partial fails
    (torch 2.13), its all-reduce does not."""
    if not hasattr(x, "device_mesh") or not any(p.is_partial()
                                                 for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def placed_like(x, ref):
    """``x`` redistributed to the placements of ``ref`` (a DTensor of the
    same rank on the same mesh); ``x`` itself where either is a plain
    tensor."""
    if not (hasattr(x, "device_mesh") and hasattr(ref, "device_mesh")):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def pin_placements(x):
    """``x`` unchanged; on a DTensor, through a redistribution to its own
    placements, whose backward puts the gradient on them too, so that the
    view that made ``x`` can take the gradient back (DTensor's backward
    of a later op may shard it where that view cannot split)."""
    if not hasattr(x, "device_mesh"):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def on_mesh():
    """The context a model runs in on DTensor parameters: plain tensors the
    model makes itself (positions, masks, zeros) count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# Back-compat aliases, as the reference's.
DEFAULT_RULES = make_rules()
MULTI_POD_RULES = make_rules(multi_pod=True)

"""Multi-pod dry-run: one train, prefill or decode step of an (architecture x
input-shape x mesh) combination on the production mesh, with nothing
allocated, and the numbers a roofline needs.

The reference lowers and compiles the step for 256 or 512 host devices.
The port runs it: in one process, inside a fake process group of 256 or
512 ranks (``launch.mesh.fake_world``).  Parameters, optimizer state,
caches and the batch are DTensors distributed by their specs
(``sharding.logical``) whose local shards are ``meta`` tensors: shapes and
dtypes, never allocated.  The step runs eagerly on them, every layer, and
the collectives DTensor issues are recorded
(``launch.roofline.collective_bytes``).  The kernels run their plain route
on each rank's meta shards (``local_map``).  (``FakeTensorMode`` would do
as well but for DTensor's own index arithmetic of a strided shard, which
it evaluates with tensors and ``tolist`` and which fake tensors refuse.)

Record keys are the reference's where they mean the same: ``roofline``
(the analytic model on H100 figures), ``analytic``, ``collectives`` (from
DTensor, not HLO; the gathers ``sharding.mesh_ops`` adds where DTensor
cannot view a sharded dim are left out of the roofline and reported under
``collectives.fallback``), ``memory.argument_bytes`` (the local shard bytes of the
step's arguments on one rank; the other memory fields are None, with the
reason), and ``compile_s``, which holds the seconds the traced step took.
There is no ``hlo_raw_cost``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  ... add --multi-pod for the 2-pod (512-rank) pass, --cluster-parallel for
  FedCCL's pod-axis mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from repro_torch.configs import (
    ALL_ARCHS,
    INPUT_SHAPES,
    get_config,
    shape_is_applicable,
)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.roofline import (
    analytic_costs,
    collective_bytes,
    model_flops,
    roofline_terms,
)
from repro_torch.models.model import build_model
from repro_torch.obs import clock
from repro_torch.optim.optimizers import adamw
from repro_torch.serving.kv_cache import cache_shapes, cache_specs
from repro_torch.sharding.logical import (
    distribute,
    logical_to_spec,
    make_rules,
    mesh_sizes,
    on_mesh,
    placements,
)
from repro_torch.training.train_step import TrainState, build_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

_MEMORY_NOTE = ("not available: the step runs eagerly on meta tensors, with "
                "no compiled program to analyse")


# ---------------------------------------------------------------------------
# Input specs (meta tensors; never allocated)
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape):
    """Returns (batch of meta tensors, batch_logical) for the given mode."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "audio":
        fe = cfg.frontend.embed_dim
        sds = {
            "embeds": _meta((B, S, fe), torch.bfloat16),
            "mask": _meta((B, S), torch.bool),
            "labels": _meta((B, S), i32),
        }
        logical = {
            "embeds": ("batch", "seq", "frontend_in"),
            "mask": ("batch", "seq"),
            "labels": ("batch", "seq"),
        }
        return sds, logical
    if cfg.family == "vlm" and shape.mode != "decode":
        npatch = cfg.frontend.tokens_per_sample
        text = S - npatch
        sds = {
            "patches": _meta((B, npatch, cfg.frontend.embed_dim), torch.bfloat16),
            "tokens": _meta((B, text), i32),
            "labels": _meta((B, text), i32),
        }
        logical = {
            "patches": ("batch", "seq", "frontend_in"),
            "tokens": ("batch", "seq"),
            "labels": ("batch", "seq"),
        }
        return sds, logical
    sds = {
        "tokens": _meta((B, S), i32),
        "labels": _meta((B, S), i32),
    }
    logical = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return sds, logical


# ---------------------------------------------------------------------------
# Distributed stand-ins
# ---------------------------------------------------------------------------


def _placed(metas: dict, specs: dict, mesh) -> dict:
    """The tree of meta tensors ``metas`` as DTensors on ``mesh`` by the
    spec tree ``specs``: shapes and dtypes, no storage."""
    return distribute(metas, mesh,
                      tree_map(lambda spec: placements(spec, mesh), specs))


def _batch_specs(metas: dict, logical: dict, rules) -> dict:
    return {k: logical_to_spec(logical[k], rules, tuple(v.shape))
            for k, v in metas.items()}


def _local_bytes(*trees) -> int:
    return sum(x.to_local().numel() * x.to_local().element_size()
               for t in trees for x in tree_leaves(t) if hasattr(x, "to_local"))


def _traced(fn, *args):
    """Run ``fn`` on the DTensor stand-ins; (seconds, collectives)."""
    t0 = clock.monotonic()
    with on_mesh():
        _, coll = collective_bytes(fn, *args)
    return clock.monotonic() - t0, coll


# ---------------------------------------------------------------------------
# One dry-run
# ---------------------------------------------------------------------------


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            remat: str = "full", moment_dtype: str = "float32",
            mla_absorb: bool = True, donate: bool = True,
            extra_rules: dict | None = None, n_microbatches: int | None = None,
            verbose: bool = True) -> dict:
    """``remat`` is recorded, feeds the analytic model and is the train
    step's (each scan repetition's forward runs again in the backward, its
    collectives with it).  ``donate`` keeps the reference's signature: an
    eager step has no buffers to donate."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    ok, reason = shape_is_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "multi_pod": multi_pod, "remat": remat, "mla_absorb": mla_absorb,
        "n_microbatches": n_microbatches,
        "extra_rules": {k: str(v) for k, v in (extra_rules or {}).items()},
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    if shape.mode == "train" and remat != "none":
        cfg = cfg.replace(remat=remat)
    n_chips = 512 if multi_pod else 256

    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        sizes = mesh_sizes(mesh)
        overrides = dict(extra_rules or {})
        if shape.mode == "decode" and shape.global_batch < sizes["data"]:
            # batch can't shard: spread the KV-cache sequence axis over `data`
            overrides.setdefault("kv_seq", "data")
        rules = make_rules(mesh, multi_pod=multi_pod, **overrides)

        model = build_model(cfg)
        params_specs = model.param_specs(rules)

        params = _placed(model.param_shapes(), params_specs, mesh)
        if shape.mode == "train":
            opt = adamw(3e-4, moment_dtype=getattr(torch, moment_dtype))
            with on_mesh():
                state = TrainState(params, opt.init(params))
            batch_m, batch_logical = input_specs(cfg, shape)
            batch = _placed(batch_m, _batch_specs(batch_m, batch_logical,
                                                  rules), mesh)
            step = build_train_step(model, cfg, opt, rules=rules,
                                    n_microbatches=n_microbatches)
            args = (state, batch)
            arg_bytes = _local_bytes(params, state.opt_state, batch)

        elif shape.mode == "prefill":
            batch_m, batch_logical = input_specs(cfg, shape)
            batch = _placed(batch_m, _batch_specs(batch_m, batch_logical,
                                                  rules), mesh)

            def step(params, batch):
                if cfg.family == "audio":
                    logits, _ = model.forward(params, embeds=batch["embeds"],
                                              mask=batch["mask"], rules=rules)
                elif cfg.family == "vlm":
                    logits, _ = model.forward(params, tokens=batch["tokens"],
                                              embeds=batch["patches"],
                                              rules=rules)
                else:
                    logits, _ = model.forward(params, tokens=batch["tokens"],
                                              rules=rules)
                # the last position's vocab-sharded row, gathered
                return torch.argmax(logits[:, -1].full_tensor(), dim=-1)

            args = (params, batch)
            arg_bytes = _local_bytes(params, batch)

        else:  # decode
            window_override = None
            if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
                window_override = cfg.long_context_window
            B, S = shape.global_batch, shape.seq_len
            caches_m = cache_shapes(model, B, S, torch.bfloat16)
            caches = _placed(caches_m, cache_specs(caches_m, rules), mesh)
            tokens = _placed({"tokens": _meta((B, 1), torch.int32)}, {
                "tokens": logical_to_spec(("batch", "seq"), rules, (B, 1))},
                mesh)["tokens"]

            def step(params, caches, tokens):
                logits, new_caches = model.decode_step(
                    params, caches, tokens, S - 1, rules=rules,
                    window_override=window_override, mla_absorb=mla_absorb)
                # the last position's vocab-sharded row, gathered
                return torch.argmax(logits[:, -1].full_tensor(), dim=-1), new_caches

            args = (params, caches, tokens)
            arg_bytes = _local_bytes(params, caches, tokens)

        compile_s, coll = _traced(step, *args)

    n_params = cfg.n_params()
    n_active = cfg.n_active_params()
    window_override = (cfg.long_context_window
                       if shape.name == "long_500k"
                       and cfg.family in ("dense", "moe", "vlm") else None)
    ana = analytic_costs(cfg, shape, n_chips, sizes,
                         remat=remat if shape.mode == "train" else "none",
                         moment_bytes=getattr(torch, moment_dtype).itemsize,
                         window_override=window_override,
                         mla_absorb=mla_absorb)
    terms = roofline_terms(
        {"flops": ana["flops_per_dev"], "bytes accessed": ana["bytes_per_dev"]},
        coll)
    mf = model_flops(cfg, shape, n_params, n_active)

    rec.update(
        status="ok",
        compile_s=round(compile_s, 1),
        n_params=n_params,
        n_active_params=n_active,
        roofline=terms.as_dict(),
        collectives=coll,
        memory={"argument_bytes": arg_bytes, "output_bytes": None,
                "temp_bytes": None, "generated_code_bytes": None,
                "note": _MEMORY_NOTE},
        analytic=ana,
        model_flops_global=mf,
        useful_flops_ratio=(mf / ana["flops_global"]) if ana["flops_global"] else None,
    )
    if verbose:
        print(json.dumps(rec, indent=None, default=str))
    return rec


# ---------------------------------------------------------------------------
# Cluster-parallel (FedCCL pod-axis) dry-run: K cluster models trained in one
# round, one a pod; the global tier is the FedAvg all-reduce over "pod".
# ---------------------------------------------------------------------------


def run_cluster_parallel(arch: str, shape_name: str = "train_4k", *,
                         remat: str = "full", verbose: bool = True) -> dict:
    """Each pod trains its cluster's model on the (data, model) sub-mesh:
    one rank's view of the round is one inner step there (``cp._inner``)
    and the global tier, every leaf's local shard all-reduced over the
    pod mesh (the reference's psum over "pod")."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.core.cluster_parallel import ClusterParallel

    shape = INPUT_SHAPES[shape_name]
    if shape.mode != "train":
        raise ValueError(f"--cluster-parallel trains: {shape_name} is "
                         f"{shape.mode}")
    cfg = get_config(arch).replace(remat=remat)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        K = mesh.shape[0]
        inner_mesh, pod_mesh = mesh["data", "model"], mesh["pod"]
        rules = make_rules(mesh)         # inner step: batch->data, FSDP->data
        model = build_model(cfg)
        opt = adamw(3e-4)
        cp = ClusterParallel(model, cfg, opt, n_clusters=K, rules=rules)

        B_cluster = shape.global_batch // K
        batch_m, batch_logical = input_specs(
            cfg, shape.__class__(shape.name, shape.seq_len, B_cluster, "train"))

        def round_step(state, batch):
            new_state, metrics = cp._inner(state, batch)
            w = 1.0 / K              # sample-weighted FedAvg, equal counts
            g = tree_map(lambda x: DTensor.from_local(
                x.to_local().to(torch.float32) * w, pod_mesh, [Partial()],
                run_check=False).redistribute(pod_mesh, [Replicate()]),
                new_state.params)
            return new_state, metrics, g

        params = _placed(model.param_shapes(), model.param_specs(rules),
                         inner_mesh)
        with on_mesh():
            state = TrainState(params, opt.init(params))
        batch = _placed(batch_m, _batch_specs(batch_m, batch_logical, rules),
                        inner_mesh)
        compile_s, coll = _traced(round_step, state, batch)

    rec = {
        "arch": arch, "shape": shape_name, "mode": "cluster_parallel",
        "mesh": "2x16x16", "n_clusters": K, "status": "ok",
        "compile_s": round(compile_s, 1),
        "collectives": coll,
    }
    if verbose:
        print(json.dumps(rec, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots_saveable"])
    ap.add_argument("--moments", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--no-mla-absorb", action="store_true")
    ap.add_argument("--cluster-parallel", action="store_true",
                    help="FedCCL pod-axis mode: K cluster models per step")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.cluster_parallel:
        rec = run_cluster_parallel(args.arch, args.shape or "train_4k",
                                   remat=args.remat)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        return

    combos = ([(a, s) for a in ALL_ARCHS for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    records = []
    for arch, shp in combos:
        try:
            rec = run_one(arch, shp, multi_pod=args.multi_pod, remat=args.remat,
                          moment_dtype=args.moments,
                          mla_absorb=not args.no_mla_absorb)
        except Exception as e:
            rec = {"arch": arch, "shape": shp, "status": "error",
                   "multi_pod": args.multi_pod,
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "status", "error")}))
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    print(f"[dryrun] ok={n_ok} skipped={n_skip} "
          f"error={len(records) - n_ok - n_skip}", file=sys.stderr)
    if any(r["status"] == "error" for r in records):
        sys.exit(1)


if __name__ == "__main__":
    main()

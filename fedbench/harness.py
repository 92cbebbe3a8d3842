"""The benchmark's machinery: cells, the measured window, the recorder of
spans and counts, the device trace, the metrics and the result line.

Everything that belongs to one configuration, one cell or one metric lives
in a file of its own that this module finds by name:

- ``configs/<config>.json``: the model's sizes, its initialisation rules,
  the training hyper-parameters and which driver runs it;
- ``workloads/<cell>.json``: the traffic (fleet or organisations, runtime,
  update size) and the limits of the comparison that decides ``correct``;
- ``drivers/<driver>.py``: builds one family's ``FedCCL`` and train_fn from
  the program's public API, drives the window and checks what it produced
  against ``reference/``;
- ``metrics/<metric>.py``: ``read(ctx)`` gives one metric's value, or
  None where the run has nothing to read.

The window is a closed loop through ``FedCCL.run``: every client trains
again as soon as its submit returns.  It closes at the first train_fn call
that starts at or after ``--seconds``, once the device has finished what
was queued; that call raises ``StopWindow``, which ends every client.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

from fedbench.reference import fold

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class StopWindow(Exception):
    """Raised in a client's train_fn once the window has closed."""


# ------------------------------------------------------------------ files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json's entry, the workload file, the configuration file)
    of cell ``name``."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = load_json(HERE / "workloads" / f"{name}.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, work, load_json(ROOT / conf["file"])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"fedbench_driver_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "fedbench_metric_" + name.replace(".", "_"))


def cell_metrics(cell: str, bench: dict, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones; each per-layer entry lists its cells."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------- weights
def init_tree(shapes: dict, rules: dict, generator, device) -> dict:
    """Random parameters for the tree of meta tensors ``shapes`` by the
    configuration's ``rules`` (leaf path suffix -> rule), drawn on
    ``device`` from ``generator`` in two calls (one normal, one uniform
    draw for the whole tree), each leaf in its own dtype.

    Rules: ``{"normal": std}``; ``{"normal": "fan_in"}`` (std 1/sqrt of
    the leaf's second-to-last dim: its input width, the layer axis of a
    stacked leaf excluded); ``"zeros"``; ``"ones"``;
    ``{"log_uniform": [lo, hi], "then": "log" | "inv_softplus"}`` (a draw
    e^U(log lo, log hi), then its log or the inverse of softplus)."""
    import torch

    flat = []

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat.append((p, v))

    walk(shapes, "")

    def rule_of(path):
        hits = [s for s in rules if path == s or path.endswith("/" + s)]
        if not hits:
            raise KeyError(f"no initialisation rule for leaf {path!r}")
        return rules[max(hits, key=len)]

    plan = [(p, v, rule_of(p)) for p, v in flat]
    n_normal = sum(v.numel() for _, v, r in plan
                   if isinstance(r, dict) and "normal" in r)
    n_unif = sum(v.numel() for _, v, r in plan
                 if isinstance(r, dict) and "log_uniform" in r)
    f32 = torch.float32
    normal = torch.randn(n_normal, generator=generator, dtype=f32,
                         device=device)
    unif = torch.rand(n_unif, generator=generator, dtype=f32, device=device)
    out, i_n, i_u = {}, 0, 0
    for path, v, r in plan:
        shape, n = tuple(v.shape), v.numel()
        if r == "zeros":
            x = torch.zeros(shape, dtype=f32, device=device)
        elif r == "ones":
            x = torch.ones(shape, dtype=f32, device=device)
        elif "normal" in r:
            std = (1.0 / math.sqrt(shape[-2]) if r["normal"] == "fan_in"
                   else float(r["normal"]))
            x = normal[i_n:i_n + n].view(shape) * std
            i_n += n
        else:
            lo, hi = (math.log(b) for b in r["log_uniform"])
            x = torch.exp(unif[i_u:i_u + n].view(shape) * (hi - lo) + lo)
            i_u += n
            x = torch.log(x) if r["then"] == "log" else \
                x + torch.log(-torch.expm1(-x))
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x.to(v.dtype)
    return _order_like(shapes, out)


def _order_like(template: dict, tree: dict) -> dict:
    return {k: (_order_like(v, tree[k]) if isinstance(v, dict) else tree[k])
            for k, v in template.items()}


def tree_leaves(tree) -> list:
    """Leaves in sorted-key, depth-first order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def federation_config(work: dict, training: dict, seed: int,
                      telemetry: bool):
    """The program's ``FedCCLConfig`` of the workload's whole ``federation``
    block (any field the config has), with the configuration's
    ``ewc_lambda``, the run's seed and telemetry on in the traced run."""
    from repro_torch.core.fedccl import ClusterSpaceConfig, FedCCLConfig

    fw = dict(work["federation"])
    fw["spaces"] = tuple(ClusterSpaceConfig(*s) for s in fw["spaces"])
    if "server_hosts" in fw:
        fw["server_hosts"] = tuple(fw["server_hosts"])
    return FedCCLConfig(**fw, ewc_lambda=training["ewc_lambda"], seed=seed,
                        telemetry=telemetry)


# what the recorder's fold tap and submit wrapper cannot see: masked sums,
# shard workers' and servers' folds
UNTAPPED = ("secure_agg", "server_shards", "server_processes", "server_hosts")


# ---------------------------------------------------------------- recorder
class Recorder:
    """Spans and counts of one run, kept in memory, all on the host's
    ``perf_counter`` clock, and the samples the correctness check reads.

    - ``steps``: (time the client step returned, items it consumed);
    - ``train_spans``: (start, end) of every train_fn call;
    - ``updates``: (request, submit returned, train seconds) of every
      shared-tier update: the client's ``fetch`` to its ``submit``;
    - ``samples``: train_fn calls captured for the reference: the first of
      the run (from the benchmark's own initial weights) and a reservoir of
      ``n_updates`` calls started in the window;
    - ``folds``: a reservoir of ``n_folds`` of the folds that the store
      made in the window and that sum (``tap_folds``), each as the store
      made it: its base, its updates in fold order and its result;
      ``fold_seen`` counts those, ``fold_taken`` the folds in which
      Algorithm 2 takes one update whole;
    - ``meta_sums``: samples, epochs and rounds submitted to each model.
    """

    def __init__(self, seed: int, n_updates: int, n_folds: int, sync=None):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.rand = random.Random(seed)
        self.sync = sync or (lambda: None)
        self.n_updates, self.n_folds = n_updates, n_folds
        self.t0 = self.deadline = self.t_close = None
        self.steps, self.train_spans, self.updates = [], [], []
        self.errors = []
        self.start_sample = None
        self.samples, self.sample_seen = [], 0
        self.folds, self.fold_seen, self.fold_taken = [], 0, 0
        self.meta_sums = defaultdict(lambda: [0, 0, 0])
        self._requests = {}

    # -- window
    def open(self, seconds: float):
        self.sync()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def in_window(self, t: float) -> bool:
        return (self.t0 is not None and t >= self.t0
                and (self.t_close is None or t <= self.t_close))

    def seconds(self) -> float:
        return self.t_close - self.t0

    def _check_close(self):
        if self.deadline is None:
            return
        if self.t_close is None and time.perf_counter() >= self.deadline:
            self.sync()
            with self.lock:
                if self.t_close is None:
                    self.t_close = time.perf_counter()
        if self.t_close is not None:
            raise StopWindow()

    # -- client hooks
    def wrap_train_fn(self, inner, capture):
        """The train_fn FedCCL runs: ``inner`` with a span and the window's
        close.  For a call sampled for the reference, ``capture(params,
        dataset, rng, anchor)`` gives its inputs; the driver's step adds
        what the program produced through ``current_sample()``, and the
        call's result is kept as ``out``."""

        def train_fn(params, dataset, rng, anchor):
            self._check_close()
            t0 = time.perf_counter()
            sample = self._choose(t0, lambda: capture(params, dataset, rng,
                                                      anchor))
            self.local.sample = sample
            try:
                out = inner(params, dataset, rng, anchor)
            except StopWindow:
                raise
            except BaseException as e:
                with self.lock:
                    self.errors.append(e)
                raise
            finally:
                self.local.sample = None
            t1 = time.perf_counter()
            self.local.last_train = t1 - t0
            with self.lock:
                self.train_spans.append((t0, t1))
            if sample is not None:
                sample["out"] = out[0]
                self._commit(sample)
            return out

        return train_fn

    def current_sample(self):
        return getattr(self.local, "sample", None)

    def _choose(self, t0, capture):
        with self.lock:
            if self.start_sample is None and self.t0 is None:
                self.start_sample = {"slot": "start"}
                return self._fill(self.start_sample, capture)
            if not self.in_window(t0) or self.n_updates == 0:
                return None
            self.sample_seen += 1
            if len(self.samples) < self.n_updates:
                slot = len(self.samples)
                self.samples.append(None)
            else:
                j = self.rand.randrange(self.sample_seen)
                if j >= self.n_updates:
                    return None
                slot = j
        return self._fill({"slot": slot}, capture)

    @staticmethod
    def _fill(sample, capture):
        sample.update(capture())
        sample.setdefault("losses", [])
        return sample

    def _commit(self, sample):
        with self.lock:
            if sample["slot"] != "start":
                self.samples[sample["slot"]] = sample

    def step(self, items: int):
        t = time.perf_counter()
        with self.lock:
            self.steps.append((t, items))

    def instrument(self, fed):
        """Wrap every client's fetch and submit (instance attributes, so
        the runtimes call them).  Refuses a federation whose folds or
        submits go where neither these wrappers nor ``tap_folds`` see."""
        unseen = [k for k in UNTAPPED if getattr(fed.cfg, k)]
        if unseen:
            raise NotImplementedError(
                f"the check reads the folds that the store makes in this "
                f"process (aggregate_models, coalesced_aggregate) and the "
                f"submits through Client.submit; with {unseen} the folds are "
                f"masked sums or run in shard workers or servers: such a "
                f"cell needs a capture of its own")
        for c in fed.clients:
            c.fetch = self._wrap_fetch(c, c.fetch)
            c.submit = self._wrap_submit(c, c.submit)

    def _wrap_fetch(self, client, fetch):
        cid = client.spec.client_id

        def wrapped(store, level, cluster_key=None, **kw):
            t = time.perf_counter()
            with self.lock:
                self._requests[(cid, level, cluster_key)] = t
            return fetch(store, level, cluster_key, **kw)

        return wrapped

    def _wrap_submit(self, client, submit):
        cid = client.spec.client_id

        def wrapped(store, level, cluster_key, new_params, meta, delta):
            ok = submit(store, level, cluster_key, new_params, meta, delta)
            t = time.perf_counter()
            train = getattr(self.local, "last_train", 0.0)
            with self.lock:
                t_req = self._requests.pop((cid, level, cluster_key), t)
                self.updates.append((t_req, t, train))
                sums = self.meta_sums[(level, cluster_key)]
                sums[0] += delta.samples_learned
                sums[1] += delta.epochs_learned
                sums[2] += delta.rounds
            return ok

        return wrapped

    # -- server hook
    @contextlib.contextmanager
    def tap_folds(self):
        """Within the block, every fold that the store makes in this process
        (``aggregate_models`` inline, ``coalesced_aggregate`` in a drain),
        that ends in the window and whose result is by Algorithm 2 a
        weighted sum, is offered to the ``folds`` reservoir.  Kept by
        reference: the program never updates a tree in place."""
        from repro_torch.core import store

        pair, many = store.aggregate_models, store.coalesced_aggregate

        def aggregate_models(base, bmeta, params, meta, delta, *a, **kw):
            out = pair(base, bmeta, params, meta, delta, *a, **kw)
            self._fold(base, bmeta, [(params, meta, delta)], *out)
            return out

        def coalesced_aggregate(base, bmeta, updates, *a, **kw):
            updates = list(updates)
            res = many(base, bmeta, updates, *a, **kw)
            self._fold(base, bmeta, updates, res.params, res.meta)
            return res

        store.aggregate_models = aggregate_models
        store.coalesced_aggregate = coalesced_aggregate
        try:
            yield
        finally:
            store.aggregate_models, store.coalesced_aggregate = pair, many

    def _fold(self, base, bmeta, updates, params, meta):
        if not self.n_folds or not self.in_window(time.perf_counter()):
            return
        metas = [((m.samples_learned, m.epochs_learned, m.round),
                  (d.samples_learned, d.epochs_learned, d.rounds))
                 for _, m, d in updates]
        if not fold.sums((bmeta.samples_learned, bmeta.epochs_learned,
                          bmeta.round), metas):
            with self.lock:
                self.fold_taken += 1
            return
        item = (base, bmeta, updates, params, meta)
        with self.lock:
            self.fold_seen += 1
            if len(self.folds) < self.n_folds:
                self.folds.append(item)
            else:
                j = self.rand.randrange(self.fold_seen)
                if j < self.n_folds:
                    self.folds[j] = item

    # -- readings
    def window_steps(self) -> list:
        return [s for s in self.steps if self.in_window(s[0])]

    def window_updates(self) -> list:
        return [u for u in self.updates if self.in_window(u[1])]

    def window_train_spans(self) -> list:
        return [s for s in self.train_spans if self.in_window(s[1])]


def run_window(rec: Recorder, seconds: float, run):
    """Open the window and call ``run()`` (a ``FedCCL.run`` of more rounds
    than the window holds) until the window's close stops every client."""
    rec.open(seconds)
    try:
        with rec.tap_folds():
            run()
    except StopWindow:
        pass
    else:
        raise RuntimeError("the run ended before the window closed: give "
                           "it more rounds")
    if rec.errors:
        raise rec.errors[0]
    if rec.t_close is None:
        raise RuntimeError("the window never closed")


# ----------------------------------------------------------------- trace
class DeviceTrace:
    """``torch.profiler`` over the window, device activity only: every
    kernel, copy and set, and the host's CUDA calls beside them."""

    def __init__(self):
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.ops, self.calls = [], []

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        self._read()

    def _read(self):
        """Operations: the events that ran on the card (kernels, copies,
        sets); calls: the host's CUDA runtime and driver calls (``cuda*``,
        ``cu*``).  By device type, which every torch 2 build's events
        carry (``activity_type`` is newer)."""
        from torch.autograd import DeviceType

        for e in self.prof.profiler.kineto_results.events():
            row = (e.name(), _ns(e, "start"), _ns(e, "duration"))
            if e.device_type() == DeviceType.CUDA:
                self.ops.append(row)
            elif row[0].startswith("cu"):
                self.calls.append(row)
        self.ops.sort(key=lambda r: r[1])
        self.calls.sort(key=lambda r: r[1])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the operations' intervals."""
        busy, end = 0, None
        for _, s, d in self.ops:
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def op_seconds(self, match) -> tuple[float, int]:
        """(seconds, count) of the operations whose name ``match`` accepts."""
        sel = [d for n, _, d in self.ops if match(n)]
        return sum(sel) / 1e9, len(sel)

    def breakdown(self, top: int = 10) -> dict:
        by = defaultdict(int)
        for n, _, d in self.ops:
            by[_short(n)] += d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for n, s, d in self.ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s, n))
            end = max(end or 0, s + d)
        gaps.sort(reverse=True)
        out = []
        for g, a, b, nxt in gaps[:top]:
            host = self._host_during(a, b)
            out.append([f"{host} before {_short(nxt)}", g / 1e9])
        return {"device_ops": [[n, d / 1e9] for n, d in ops],
                "idle_gaps": out}

    def _host_during(self, a: int, b: int) -> str:
        """The CUDA call that covered most of [a, b] on the host, or
        ``host code`` where none did."""
        best, name = 0, "host code"
        for n, s, d in self.calls:
            if s >= b:
                break
            cover = min(b, s + d) - max(a, s)
            if cover > best:
                best, name = cover, n
        return name


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    return f() if f is not None else int(getattr(event, f"{what}_us")() * 1000)


def _short(name: str) -> str:
    name = name.split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:80]


# ------------------------------------------------------------ host watch
class HostWatch:
    """What the host did over the window, for the log and not a metric:
    the process's CPU seconds and context switches, the machine's steal and
    busy shares (``/proc/stat``), the interpreter's collections and the
    caching allocator's calls to the device."""

    ALLOC = ("num_device_alloc", "num_device_free", "num_alloc_retries")

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.collections, self._t = [], None

    def _collect(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.collections.append((info["generation"],
                                     time.perf_counter() - self._t))
            self._t = None

    def _read(self):
        import resource

        import torch

        try:
            with open("/proc/stat") as f:
                cpu = [int(x) for x in f.readline().split()[1:9]]
        except OSError:
            cpu = None
        mem = torch.cuda.memory_stats() if self.on_card else {}
        return (resource.getrusage(resource.RUSAGE_SELF), cpu,
                [mem.get(k, 0) for k in self.ALLOC])

    def __enter__(self):
        self.start = self._read()
        gc.callbacks.append(self._collect)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collect)
        self.end = self._read()

    def line(self, rec: Recorder, slice_s: float = 5.0) -> str:
        (ru0, cpu0, mem0), (ru1, cpu1, mem1) = self.start, self.end
        w = rec.seconds()
        work = defaultdict(int)
        for t, items in rec.window_steps():
            work[int((t - rec.t0) // slice_s)] += items
        rates = [round(work[i] / slice_s, 1)
                 for i in range(int(w // slice_s))]
        out = (f"window {w:.3f} s; items/s by {slice_s:g} s slice {rates}; "
               f"process cpu {(ru1.ru_utime - ru0.ru_utime) / w:.3f} user "
               f"{(ru1.ru_stime - ru0.ru_stime) / w:.3f} sys a second; "
               f"switches {ru1.ru_nvcsw - ru0.ru_nvcsw} voluntary "
               f"{ru1.ru_nivcsw - ru0.ru_nivcsw} forced; ")
        if cpu0 and cpu1:
            d = [b - a for a, b in zip(cpu0, cpu1)]
            total = max(sum(d), 1)
            out += (f"machine busy {(total - d[3] - d[4]) / total:.3f} "
                    f"steal {d[7] / total:.4f}; ")
        gen2 = [s for g, s in self.collections if g == 2]
        out += (f"collections {len(self.collections)} "
                f"({sum(s for _, s in self.collections):.3f} s; "
                f"{len(gen2)} full, longest "
                f"{max([s for _, s in self.collections], default=0):.3f} s)")
        if self.on_card:
            out += "; allocator " + " ".join(
                f"{k[4:]} {b - a}" for k, a, b in zip(self.ALLOC, mem0, mem1))
        return out


# ---------------------------------------------------------------- context
class Context:
    """What a metric's ``read`` sees."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             log=print) -> dict:
    """Run cell ``cell`` once; returns the result object."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    _, work, conf = cell_spec(cell, bench)
    import torch

    from fedbench.reference.precision import exact_matmuls

    exact_matmuls()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    drv = driver(conf["driver"]).Cell(conf, work, seed, dev, trace)
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"[fedbench] {cell} seed {seed}: set-up {setup_s:.3f} s; card: "
        f"{card_line() if on_card else device}")
    dt = DeviceTrace() if trace and on_card else None
    with HostWatch(on_card) as host:
        if dt is not None:
            with dt:
                drv.window(seconds)
        else:
            drv.window(seconds)
    rec = drv.rec
    log(f"[fedbench] {host.line(rec)}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ctx = Context(work=work, config=conf, rec=rec, seconds=rec.seconds(),
                  setup_s=setup_s, trace=dt, stats=drv.stats(),
                  telemetry=drv.telemetry())
    metrics = {}
    for m in cell_metrics(cell, bench, trace):
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # a client's error ends the run (``run_window`` raises it): every call
    # counted finished
    attempted = len(rec.window_train_spans())
    from fedbench.checks import PROGRAM, readings

    t_check = time.perf_counter()
    got = readings(drv, (PROGRAM,))[PROGRAM]
    log(f"[fedbench] check of {1 + len(rec.samples)} updates and "
        f"{len(rec.folds)} of the window's {rec.fold_seen} folds: "
        f"{time.perf_counter() - t_check:.3f} s")
    checks = [{"name": k, "value": got[k], "limit": lim}
              for k, lim in work["limits"].items()]
    correct = all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(dev) if on_card
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if dt is not None:
        result["device"]["busy_s"] = dt.busy_s()
        result["device"]["window_s"] = dt.window_s
        result["breakdown"] = dt.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result

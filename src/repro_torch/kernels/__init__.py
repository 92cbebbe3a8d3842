"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each kernel package has two modules:
  ops.py — the public wrapper: it checks its tensors, launches the CUDA
           kernel (``csrc/<name>.cu``) for CUDA tensors and counts the
           launch in its ``launches`` integer (and, where the wrapper has
           several routes, in the route's own ``launches_<route>``)
           through ``build.count``, under a lock, and runs the plain
           version for CPU tensors
  ref.py — the plain PyTorch version the kernel is checked against

The device decides the route; there is no switch and no fallback.  The
CUDA sources build at first use (``build.py``).
"""

KERNELS = ("fedavg_agg", "lstm_cell", "ewc_update", "dp_clip_noise",
           "ssd_chunk", "local_attn")


def _ops(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per kernel (CPU calls are not counted)."""
    return {name: _ops(name).launches for name in KERNELS}


def reset_launch_counts() -> None:
    """Set every counter of every kernel to 0: ``launches`` and the route
    counters beside it (``launches_tc``, ``launches_seq_fwd``, ...)."""
    for name in KERNELS:
        mod = _ops(name)
        for attr in [a for a in vars(mod) if a.startswith("launches")]:
            setattr(mod, attr, 0)

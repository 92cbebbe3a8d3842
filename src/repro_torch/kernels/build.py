"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, from the sources in this package only, with
one ``nvcc`` process per source started together, and is cached under
``build/repro_torch_kernels/`` at the repository root by a hash of the
sources and flags.  A missing ``nvcc`` or a failed build raises: there is
no fallback to another implementation.

Thread safety: client threads of the threaded runtime launch kernels
concurrently.  ``library()`` builds and loads under ``_load_lock`` (one
thread builds, the others wait for it); ``count`` and ``workspace`` touch
the wrappers' launch counters and kept scratch under ``_state_lock``;
``launch_sized`` runs the launchers that set their kernel's shared-memory
limit to the call's size under ``_sized_lock``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_DEFAULT_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every exported launch function; every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "fedavg_agg_launch": [_P, _P, _I, _L, _P, _P],
    "lstm_cell_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "ewc_update_launch": [_F, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    "dp_clip_noise_launch": [_P, _P, _F, _F, _L, _P, _P, _P],
    "ssd_chunk_launch": [*[_P] * 4, *[_I] * 8, _P, _P, _P],
    "ssd_chunk_bwd_launch": [*[_P] * 6, *[_I] * 8, *[_P] * 5, _P],
    "local_attn_tf32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               *[_L] * 12, _F, _I, _I, _I, _P, _P],
    "local_attn_tc_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             *[_L] * 12, _F, _I, _I, _P, _P],
    "local_attn_bwd_tf32_launch": [*[_P] * 11, *[_I] * 6, _F, *[_I] * 3,
                                   _P],
    "local_attn_bwd_tc_launch": [*[_P] * 10, *[_I] * 6, *[_L] * 12, _F, _I,
                                 _I, _P],
    "lstm_seq_fwd_launch": [*[_P] * 6, *[_I] * 6, *[_P] * 5, _P],
    "lstm_seq_bwd_launch": [*[_P] * 7, *[_I] * 5, *[_P] * 3, _P],
    "fedavg_agg_leaves_launch": [_P, _P],
    "fedavg_leaf_fold_size": [],
}

_lib = None
_load_lock = threading.Lock()    # the library's build and load
_state_lock = threading.Lock()   # launch counters and kept workspaces
_sized_lock = threading.Lock()   # set-the-limit-then-launch launchers


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then the
    toolkit's default install prefix; raises if none has it."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = CUDA_DEFAULT_HOME / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (searched CUDA_HOME, CUDA_PATH, PATH and "
        f"{CUDA_DEFAULT_HOME}); the CUDA kernels of repro_torch cannot be "
        "built.  CPU tensors use the plain PyTorch versions and need no build.")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (or find cached) ``libkernels-<hash>.so``; returns its path.
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills)
    lands in ``build.log`` beside it."""
    srcs = sources()
    out = BUILD_DIR / f"libkernels-{_digest(srcs)}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        os.replace(lib, out)     # atomic: a concurrent build never sees half
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, by one thread)."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch_sized(name: str, *args) -> int:
    """Call the library's launch function ``name`` under ``_sized_lock``:
    for the launchers that set their kernel's dynamic shared-memory limit
    to this call's size and then launch (the LSTM sequence scans,
    ``local_attn_tf32.cu`` and both backward routes, ``ssd_chunk`` and its
    backward).  The limit belongs to the kernel, not to the thread, so a
    thread launching the same kernel at a smaller size could lower it
    between another thread's set and launch, and that launch would fail
    with "invalid argument" (two client threads running the encoder's and
    the decoder's scans did, on an H100)."""
    fn = getattr(library(), name)
    with _sized_lock:
        return fn(*args)


def count(module: str, *counters: str) -> None:
    """Add one to each launch counter ``counters`` (``launches``,
    ``launches_leaves``, ...) of the wrapper module named ``module``.  A
    bare ``launches += 1`` is a load, an add and a store that a thread
    switch can split; this takes the lock."""
    mod = sys.modules[module]
    with _state_lock:
        for name in counters:
            setattr(mod, name, getattr(mod, name) + 1)


def workspace(cache: dict, device: torch.device, stream: int,
              n: int) -> torch.Tensor:
    """A wrapper's kept scratch of ``n`` zeroed floats on ``device`` for
    ``stream``, made at its first use and kept in ``cache`` under
    ``(device.index, stream)``: kernels on one stream run in order, so
    they can share it; two streams never do."""
    key = (device.index, stream)
    work = cache.get(key)
    if work is None:
        with _state_lock:
            work = cache.get(key)
            if work is None:
                work = cache[key] = torch.zeros(n, dtype=torch.float32,
                                                device=device)
    return work


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if status != 0:
        text = library().kernels_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status} ({text})")


def on_cuda(name: str, *tensors) -> bool:
    """The route a wrapper takes: True for CUDA tensors (the kernel), False
    for CPU tensors (the plain version).  Raises on any other device and on
    tensors spread over more than one device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no route for device {dev} (cpu or cuda)")
    return dev.type == "cuda"


def require_f32_contiguous(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on the CUDA ``device``, as the pointer-sized
    integer the launch functions take.  Read without building a
    ``torch.cuda.Stream`` (4 us a call on an H100 host,
    tools/ewc_wrapper_split.py): the same handle as
    ``torch.cuda.current_stream(device).cuda_stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)

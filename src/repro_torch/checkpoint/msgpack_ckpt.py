"""Checkpointing: msgpack-serialized parameter trees, with no ``msgpack``
package.

The encoder and decoder cover the subset of msgpack the repo writes: nil,
bool, int (fixint, uint/int 8-64), float64, str (fixstr, str8/16/32), bin
(bin8/16/32), array (fixarray, array16/32), map (fixmap, map16/32) in the
dict's own key order, and ext (fixext1/2/4/8/16 where the length fits
exactly, ext8/16/32 otherwise).  Their bytes equal
``msgpack.packb(obj, default=..., use_bin_type=True)`` of the reference's
``repro.checkpoint.msgpack_ckpt.packb``, so checkpoints and frames cross
between the packages both ways.

Tensors and numpy arrays are stored in ext type 1 as
``packb((dtype, shape, raw))``: the dtype string is explicitly
little-endian (``"<f4"``; one-byte types keep their name, ``"int8"``), the
bytes are little-endian and C-ordered, and bfloat16 is ``"bfloat16"`` over
its 16-bit patterns.  A tensor is moved to the CPU and made contiguous
first, so the bytes do not depend on the device it lay on.  msgpack does
not sort map keys: two trees give equal bytes only when their dicts hold
their keys in the same order.

``save_store``/``load_store`` persist a whole store (global + every cluster
model + metadata) so a server can restart without losing federation
progress.
"""

from __future__ import annotations

import pathlib
import struct
import sys
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

_EXT_ARRAY = 1


class ExtType(NamedTuple):
    """An ext value of a code this codec does not decode (msgpack's own
    ``ExtType`` compares equal to it: both are ``(code, data)`` tuples)."""

    code: int
    data: bytes


# ------------------------------------------------------------------ encoder
def _array_parts(obj) -> tuple[str, list, bytes]:
    """(dtype string, shape, little-endian C-order bytes) of a tensor or a
    numpy array, as the reference's ``_default`` builds them."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
            if sys.byteorder == "big":
                arr = arr.astype("<u2")
            return "bfloat16", list(t.shape), arr.tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(obj)
        if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
            bits = arr.view(np.uint16)
            if sys.byteorder == "big":
                bits = bits.astype("<u2")
            return "bfloat16", list(arr.shape), bits.tobytes()
    dt = arr.dtype
    if dt.itemsize > 1 and dt.byteorder != "|":
        if dt.byteorder == ">" or (dt.byteorder == "="
                                   and sys.byteorder == "big"):
            arr = arr.astype(dt.newbyteorder("<"))
        dtype_str = dt.newbyteorder("<").str
    else:
        dtype_str = str(dt)
    return dtype_str, list(arr.shape), arr.tobytes()


def _default(obj):
    """What a value msgpack has no type for becomes: tensors and arrays an
    ext of type 1, numpy scalars Python numbers."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return ExtType(_EXT_ARRAY, packb(_array_parts(obj)))
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _header(out: list, n: int, fix_base: int | None, fix_max: int,
            codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, then the 8-, 16-
    and 32-bit forms (``codes``; None where the type has no 8-bit form)."""
    if fix_base is not None and n < fix_max:
        out.append(bytes((fix_base | n,)))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"{n} entries or bytes are too many for msgpack")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack("b" if v < 0 else "B", v))
    elif 0 < v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(obj, out: list, default_used: bool = False) -> None:
    # the order of msgpack's own packer: ExtType (a tuple) before arrays
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, ExtType):
        data = bytes(obj.data)
        n = len(data)
        if n in _FIXEXT:
            out.append(bytes((_FIXEXT[n],)))
        else:
            _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack("b", obj.code))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif not default_used:
        _pack(_default(obj), out, default_used=True)
    else:
        raise TypeError(f"cannot serialize {obj!r}")


def packb(obj) -> bytes:
    """Serialize one parameter tree (tensors and arrays through the ext
    codec); the bytes of the reference's ``packb`` of the same tree."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ decoder
class _Reader:
    """msgpack decoding of the formats ``packb`` writes (and float32, which
    other writers use), with ``raw=False`` strings and any map key."""

    def __init__(self, raw: bytes, ext_hook):
        self.buf = memoryview(raw)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        out = self.buf[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.read_map(n)
            return self.read_ext(n)
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:
            return self.read_ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read_ext(self, n: int):
        code = self.unpack("b")
        return self.ext_hook(code, self.take(n))


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(raw: bytes, ext_hook):
    reader = _Reader(raw, ext_hook)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the value")
    return out


def _decode_array(data: bytes) -> tuple[str, list, bytes]:
    dtype, shape, raw = _unpack(data, ExtType)
    return dtype, [int(s) for s in shape], raw


def _bf16_bits(raw: bytes) -> np.ndarray:
    u16 = np.frombuffer(raw, "<u2")
    return u16.astype(np.uint16) if sys.byteorder == "big" else u16


def _to_numpy(dtype: str, shape: list, raw: bytes) -> np.ndarray:
    if dtype == "bfloat16":
        import ml_dtypes   # only for bf16 arrays; ships with JAX and numpy users

        return _bf16_bits(raw).view(ml_dtypes.bfloat16).reshape(shape)
    arr = np.frombuffer(raw, dtype).reshape(shape)
    if arr.dtype.byteorder in ("<", ">"):
        # an explicit order here means a non-native one: hand consumers
        # native order
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def _to_tensor(dtype: str, shape: list, raw: bytes,
               device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(_bf16_bits(raw).view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape).to(device)
    arr = np.frombuffer(raw, dtype).reshape(shape)
    arr = arr.astype(arr.dtype.newbyteorder("="))        # a writable copy
    return torch.from_numpy(arr).to(device)


def unpackb(raw: bytes, device=None):
    """Inverse of ``packb`` (tuples come back as lists, like msgpack), with
    arrays as tensors on ``device`` (``None``: CUDA, as the entry points;
    see ``utils.device.resolve_device``).  Other ext codes come back as
    ``ExtType``."""
    dev = resolve_device(device)

    def hook(code, data):
        if code == _EXT_ARRAY:
            return _to_tensor(*_decode_array(data), dev)
        return ExtType(code, data)
    return _unpack(raw, hook)


def unpackb_np(raw: bytes):
    """``unpackb`` with arrays as host numpy arrays (bfloat16 as
    ``ml_dtypes.bfloat16``)."""
    def hook(code, data):
        if code == _EXT_ARRAY:
            return _to_numpy(*_decode_array(data))
        return ExtType(code, data)
    return _unpack(raw, hook)


def save_pytree(path, tree):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(tree))


def load_pytree(path, device=None):
    with open(path, "rb") as f:
        return unpackb(f.read(), device=device)


# ---------------------------------------------------------------- ModelStore
def save_store(path, store):
    """Persist every model of ``store`` (flat or sharded) with its meta, in
    the reference's layout: ``{key: {"params": ..., "meta": {...}}}`` with
    the global model first."""
    from repro_torch.core.store import GLOBAL_KEY

    store.sync_mirrors()
    blob = {}
    for key in [GLOBAL_KEY] + store.keys():
        params, meta = store._records[key].snapshot()
        blob[key] = {
            "params": params,
            "meta": {"samples_learned": meta.samples_learned,
                     "epochs_learned": meta.epochs_learned,
                     "round": meta.round},
        }
    save_pytree(path, blob)


def load_store(path, agg_cfg=None, device=None):
    """A flat ``ModelStore`` holding every model of a checkpoint, tensors
    on ``device``."""
    from repro_torch.core.aggregation import AggregationConfig, ModelMeta
    from repro_torch.core.store import GLOBAL_KEY, ModelRecord, ModelStore

    blob = load_pytree(path, device=device)
    store = ModelStore(blob[GLOBAL_KEY]["params"],
                       agg_cfg=agg_cfg or AggregationConfig())
    for key, rec in blob.items():
        meta = ModelMeta(**{k: int(v) for k, v in rec["meta"].items()})
        if key == GLOBAL_KEY:
            rec_g = store._records[GLOBAL_KEY]
            rec_g.swap(rec_g.params, meta)
        else:
            store._records[key] = ModelRecord(rec["params"], meta)
    return store

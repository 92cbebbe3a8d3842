"""The port's msgpack codec (``repro_torch.checkpoint.msgpack_ckpt``, no
``msgpack`` package) against the reference's
``repro.checkpoint.msgpack_ckpt``, which packs with ``msgpack``.

Bytes must be equal for the same structure: every width boundary of int,
str, bin, array, map and ext, and tensors (or numpy arrays) of every dtype
the repo stores, 0-d, empty and non-contiguous ones too.  Each package
decodes the other's bytes, and store checkpoints cross between the
packages both ways with parameters bit-equal and metadata equal.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as ref
from repro.core import aggregation as jagg
from repro.core import store as jstore
from repro_torch.checkpoint import msgpack_ckpt as codec
from repro_torch.core import aggregation as agg
from repro_torch.core import store as tstore

DTYPES = ("float32", "float16", "bfloat16", "int8", "int32", "int64",
          "uint8", "bool")
SHAPES = ((), (0,), (3, 0), (7,), (2, 3, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's torch work, module fixtures
    included: the suite's xdist workers share the cores, and torch's
    default pool in each would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def boundary_values():
    """Scalars and containers at every msgpack width boundary."""
    ints = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
            0x100000000, 2**64 - 1, -1, -0x20, -0x21, -0x80, -0x81, -0x8000,
            -0x8001, -2**31, -2**31 - 1, -2**63]
    strs = ["", "x" * 31, "x" * 32, "y" * 255, "y" * 256, "z" * 65535,
            "z" * 65536, "ü€😀" * 5]
    bins = [b"", b"\0" * 255, b"\1" * 256, b"\2" * 65535, b"\3" * 65536]
    arrays = [list(range(n)) for n in (0, 15, 16, 65535, 65536)]
    maps = [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65535, 65536)]
    exts = [(5, b"a" * n) for n in (1, 2, 3, 4, 8, 16, 17, 255, 256, 65535,
                                    65536)]
    return {
        "none": [None], "bool": [True, False], "int": ints,
        "float": [0.0, -0.0, 1.5, -2.25e-300, float("inf"), 1e308],
        "str": strs, "bin": bins, "array": arrays, "map": maps,
        "ext": exts,
        "mixed": [{"a": [1, (2, 3), {"b": None}], 7: b"x", "c": 2.5,
                   "d": [np.float32(1.25), np.int64(-5), np.uint8(200),
                         np.float64(0.1)]}],
    }


@pytest.mark.parametrize("kind", sorted(boundary_values()))
def test_bytes_equal_reference_at_every_width(kind):
    for v in boundary_values()[kind]:
        mine = codec.ExtType(*v) if kind == "ext" else v
        theirs = msgpack.ExtType(*v) if kind == "ext" else v
        want = ref.packb(theirs)
        assert codec.packb(mine) == want, repr(v)[:60]
        # each package decodes the other's bytes
        got = codec.unpackb_np(want)
        back = ref.unpackb_np(codec.packb(mine))
        expect = msgpack.unpackb(want, raw=False, strict_map_key=False)
        if kind == "float" and v != v:
            continue
        assert got == expect and back == expect, repr(v)[:60]


def numpy_array(dtype, shape, rng):
    x = np.asarray(rng.standard_normal(shape) * 40)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    return x.astype(dtype)


def as_tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def same_tensor(t, u):
    if t.dtype == torch.bfloat16:
        t, u = t.view(torch.int16), u.view(torch.int16)
    return t.dtype == u.dtype and t.shape == u.shape and torch.equal(t, u)


@pytest.mark.parametrize("dtype", DTYPES)
def test_arrays_bytes_equal_reference_and_decode_both_ways(dtype):
    rng = np.random.default_rng(DTYPES.index(dtype))
    for shape in SHAPES:
        a = numpy_array(dtype, shape, rng)
        t = as_tensor(a)
        want = ref.packb({"x": a, "n": 3})
        assert codec.packb({"x": t, "n": 3}) == want, shape
        assert codec.packb({"x": a, "n": 3}) == want, shape
        got = codec.unpackb(want, device="cpu")
        assert got["n"] == 3 and same_tensor(got["x"], t), shape
        arr = codec.unpackb_np(want)["x"]
        assert arr.dtype == a.dtype and arr.shape == a.shape
        assert arr.tobytes() == a.tobytes()
        theirs = ref.unpackb_np(codec.packb({"x": t}))["x"]
        assert theirs.dtype == a.dtype and theirs.tobytes() == a.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_non_contiguous_tensors_pack_as_their_contiguous_copies(dtype):
    rng = np.random.default_rng(9)
    a = numpy_array(dtype, (6, 8), rng)
    t = as_tensor(a)
    for view in (t[:, ::2], t.T, t[1:4, 2:7], t.reshape(4, 12)[:, 3]):
        assert not view.is_contiguous()
        want = ref.packb(view.contiguous().view(torch.int16).numpy()
                         .view(ml_dtypes.bfloat16) if dtype == "bfloat16"
                         else view.contiguous().numpy())
        assert codec.packb(view) == want
        assert same_tensor(codec.unpackb(want, device="cpu"),
                           view.contiguous())


def test_other_ext_codes_decode_to_ext_pairs_and_garbage_raises():
    raw = ref.packb([msgpack.ExtType(7, b"abc"), msgpack.ExtType(100, b"q")])
    got = codec.unpackb(raw, device="cpu")
    assert got == [codec.ExtType(7, b"abc"), codec.ExtType(100, b"q")]
    assert got == [msgpack.ExtType(7, b"abc"), (100, b"q")]
    assert codec.packb(got) == raw
    # codes are signed bytes on the wire (msgpack reserves the negative
    # ones; its Timestamp is -1)
    neg = codec.packb(codec.ExtType(-5, b"q"))
    assert neg == b"\xd4\xfbq" and codec.unpackb_np(neg) == (-5, b"q")
    with pytest.raises(ValueError):
        codec.unpackb_np(raw + b"\x00")           # bytes after the value
    with pytest.raises(ValueError):
        codec.unpackb_np(b"\xc1")                 # never used
    with pytest.raises(ValueError):
        codec.unpackb_np(b"\xda\x00\x05ab")       # ends inside a str16
    with pytest.raises(TypeError):
        codec.packb({"x": object()})
    with pytest.raises(OverflowError):
        codec.packb(2**64)
    # float32 (0xca), which other writers use
    assert codec.unpackb_np(b"\xca\x3f\xc0\x00\x00") == 1.5


def test_unpackb_without_a_device_follows_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.unpackb(codec.packb({"x": torch.zeros(2)}))


# ------------------------------------------------------------ store files
def np_tree(rng):
    return {"b": rng.standard_normal(5).astype(np.float32),
            "a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "v": rng.standard_normal(2).astype(np.float32)}}


def torch_tree(t):
    return {k: torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in t.items()}


def jax_tree(t):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def leaves(t):
    return [x for k in sorted(t) for x in
            (leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]


def fill(store, rng, mod, tree):
    """A few folds on every model, so params and metas are not the init's."""
    for lk in [("global", None), ("cluster", "loc:0"), ("cluster", "ori:1")]:
        for s in (30, 50, 70):
            store.handle_model_update(*lk, tree(np_tree(rng)),
                                      mod.ModelMeta(s, 2, 1),
                                      mod.UpdateDelta(s, 2, 1))
    store.drain_all()


def assert_stores_equal(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for lk in [("global", None)] + [("cluster", k) for k in a.keys()]:
        ma, mb = a.meta(*lk), b.meta(*lk)
        assert (ma.samples_learned, ma.epochs_learned, ma.round) == \
            (mb.samples_learned, mb.epochs_learned, mb.round)
        for x, y in zip(leaves(a.params(*lk)), leaves(b.params(*lk)),
                        strict=True):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("sharded", [False, True])
def test_save_and_load_store_round_trip(tmp_path, sharded):
    rng = np.random.default_rng(5)
    keys = ["loc:0", "ori:1"]
    init = torch_tree(np_tree(rng))
    store = (tstore.ShardedModelStore(init, keys, n_shards=2,
                                      batch_aggregation=True)
             if sharded else tstore.ModelStore(init, keys,
                                               batch_aggregation=True))
    fill(store, rng, agg, torch_tree)
    path = tmp_path / "ckpt" / "store.msgpack"
    codec.save_store(path, store)
    back = codec.load_store(path, device="cpu")
    assert isinstance(back, tstore.ModelStore)
    assert_stores_equal(back, store)
    assert back.meta("global").round == 3
    # the global model comes first, as the reference writes it
    assert next(iter(codec.unpackb_np(path.read_bytes()))) == \
        tstore.GLOBAL_KEY


def test_checkpoints_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(7)
    keys = ["loc:0", "ori:1"]
    init = np_tree(rng)
    mine = tstore.ShardedModelStore(torch_tree(init), keys, n_shards=2,
                                    batch_aggregation=True)
    theirs = jstore.ShardedModelStore(jax_tree(init), keys, n_shards=2,
                                      batch_aggregation=True)
    fill(mine, np.random.default_rng(1), agg, torch_tree)
    fill(theirs, np.random.default_rng(1), jagg, jax_tree)
    codec.save_store(tmp_path / "port.msgpack", mine)
    ref.save_store(tmp_path / "ref.msgpack", theirs)
    # port file -> reference store, reference file -> port store
    assert_stores_equal(ref.load_store(tmp_path / "port.msgpack"), mine)
    assert_stores_equal(codec.load_store(tmp_path / "ref.msgpack",
                                         device="cpu"), theirs)
    # a tree saved by one package loads in the other bit for bit
    tree = torch_tree(np_tree(rng))
    codec.save_pytree(tmp_path / "t.msgpack", tree)
    got = ref.load_pytree(tmp_path / "t.msgpack")
    assert all(np.asarray(x).tobytes() == y.numpy().tobytes()
               for x, y in zip(leaves(got), leaves(tree), strict=True))
    ref.save_pytree(tmp_path / "j.msgpack", got)
    assert (tmp_path / "j.msgpack").read_bytes() == \
        (tmp_path / "t.msgpack").read_bytes()
    back = codec.load_pytree(tmp_path / "j.msgpack", device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(leaves(back), leaves(tree), strict=True))


def test_codec_needs_no_msgpack_package(tmp_path):
    """Import and use the codec in a process where ``import msgpack``
    fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'msgpack' or name.startswith('msgpack.'):\n"
        "            raise ImportError('msgpack blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from repro_torch.checkpoint import msgpack_ckpt as c\n"
        "from repro_torch.core.store import ModelStore\n"
        "s = ModelStore({'w': torch.arange(4.0)}, ['loc:0'])\n"
        f"c.save_store({str(tmp_path / 's.msgpack')!r}, s)\n"
        f"b = c.load_store({str(tmp_path / 's.msgpack')!r}, device='cpu')\n"
        "assert torch.equal(b.params('cluster', 'loc:0')['w'],"
        " torch.arange(4.0))\n"
        "assert 'msgpack' not in sys.modules\n"
        "try:\n"
        "    import msgpack\n"
        "except ImportError:\n"
        "    print('blocked')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         cwd=str(pathlib.Path(__file__).resolve()
                                 .parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "blocked"

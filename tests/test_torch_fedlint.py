"""The repo's static server checks (``scripts/fedlint``, docs/INVARIANTS.md)
held over the PyTorch port.

The rules scope themselves to ``src/repro/`` through module-level
constants that their ``applies``/``finalize`` methods read at call time.
Here those constants are pointed at ``src/repro_torch/`` with
``monkeypatch``, so the port's store locks, clocks, ring lookups and wire
constants answer to the same invariants as the reference's.  The wire
rule keeps the reference's spec (``docs/WIRE_PROTOCOL.md``): the port
speaks the reference's wire.

The kernel-twin rule's package layout (``<name>.py`` invoking
``pl.pallas_call``) does not apply to the port, whose kernels live in
``kernels/csrc/*.cu``; its signature-parity check (FED302) does, and is
run here with the rule's own helpers.

The analyzer lives at ``scripts/fedlint`` under the repo root, so the root
goes on ``sys.path`` before importing it.
"""

import pathlib
import shutil
import sys

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from scripts.fedlint import core  # noqa: E402
from scripts.fedlint.rules import (  # noqa: E402
    REGISTRY,
    determinism,
    elasticity,
    locks,
    obs,
    wire,
)
from scripts.fedlint.rules.kernels import (  # noqa: E402
    _params,
    _public_functions,
    _twin_mismatch,
)

REF, PORT = "src/repro/", "src/repro_torch/"
PORT_KERNELS = REPO_ROOT / PORT / "kernels"
#: every rule whose scope is retargeted; the kernel-twin rule is not run
#: whole (see the module docstring)
SERVER_RULES = ("lock-discipline", "hatch-policy", "lock-order",
                "epoch-routing", "determinism", "observability",
                "wire-drift")

#: oracles whose twin in ``ops.py`` takes a parameter the oracle lacks,
#: with why.  Each entry pins the one mismatch the rule reports, so any
#: other drift still fails.
TWIN_EXCEPTIONS = {
    ("local_attn", "local_attention_bwd_ref"): (
        "local_attention_bwd",
        "extra required positional parameter `lse`",
        # the CUDA backward is a flash-attention backward: it rebuilds the
        # softmax from the forward's saved row log-sum-exp instead of
        # recomputing it, so `lse` is an input; the oracle recomputes the
        # softmax from q and k and needs none
    ),
}


def _port(rel):
    return rel.replace(REF, PORT, 1)


def retarget(monkeypatch):
    """Point every server rule's module-level scope at the port."""
    monkeypatch.setattr(locks, "TARGETS",
                        tuple(_port(t) for t in locks.TARGETS))
    for mod in (determinism, obs):
        for name in ("CORE_PREFIX", "OBS_PREFIX", "SANCTIONED_CLOCK"):
            monkeypatch.setattr(mod, name, _port(getattr(mod, name)))
    monkeypatch.setattr(elasticity, "SCOPE_PREFIXES",
                        tuple(_port(p) for p in elasticity.SCOPE_PREFIXES))
    # OP_FILES is built from TRANSPORT and SERVER_PROC at import, so it is
    # patched alongside them; DOC stays the reference's spec
    for name in ("TRANSPORT", "SERVER_PROC"):
        monkeypatch.setattr(wire, name, _port(getattr(wire, name)))
    monkeypatch.setattr(wire, "OP_FILES",
                        tuple(_port(p) for p in wire.OP_FILES))


def _run(names, paths, root=REPO_ROOT):
    return core.run(paths, rules=[REGISTRY[n]() for n in names], root=root)


# =========================================================================
# the retargeted scopes
# =========================================================================


def test_retargeted_scopes_reach_the_port_only(monkeypatch):
    """``applies`` reads the patched globals when it is called: before the
    patch the port is out of every scope, after it the port is in and the
    reference is out; every patched path names a file of the port."""
    probes = {
        "lock-discipline": f"{PORT}core/store.py",
        "lock-order": f"{PORT}core/transport.py",
        "epoch-routing": f"{PORT}launch/shard_server.py",
        "determinism": f"{PORT}core/fetch.py",
        "observability": f"{PORT}obs/record.py",
    }
    for name, rel in probes.items():
        assert not REGISTRY[name]().applies(rel), name
    retarget(monkeypatch)
    for name, rel in probes.items():
        rule = REGISTRY[name]()
        assert rule.applies(rel), name
        assert not rule.applies(rel.replace(PORT, REF, 1)), name
    for rel in (*locks.TARGETS, *wire.OP_FILES, determinism.SANCTIONED_CLOCK,
                obs.SANCTIONED_CLOCK):
        assert rel.startswith(PORT) and (REPO_ROOT / rel).is_file(), rel
    assert wire.DOC == "docs/WIRE_PROTOCOL.md"


@pytest.mark.parametrize("name", SERVER_RULES)
def test_port_passes_server_rule(monkeypatch, name):
    """Every retargeted rule over the whole port: no finding, except the
    wire rule's one port-only op, ``ready`` (a spawned worker's handshake
    to its parent on its multiprocessing queue; it never crosses TCP)."""
    retarget(monkeypatch)
    findings = _run([name], [PORT.rstrip("/")])
    if name != "wire-drift":
        assert findings == [], [f.render() for f in findings]
        return
    assert len(findings) == 1, [f.render() for f in findings]
    (f,) = findings
    assert (f.rule, f.path) == ("FED403", f"{PORT}core/server_proc.py")
    assert "`ready`" in f.message and "missing from the catalog" in f.message
    readme = (REPO_ROOT / "README.md").read_text()
    port_section = readme[readme.index("## The PyTorch/CUDA port"):]
    assert '["ready", idx]' in port_section


# =========================================================================
# kernel-twin signature parity (FED302's check)
# =========================================================================

PORT_KERNEL_PKGS = sorted(
    p.name for p in PORT_KERNELS.iterdir()
    if p.is_dir() and (p / "ref.py").is_file())


@pytest.mark.parametrize("pkg", PORT_KERNEL_PKGS)
def test_port_kernel_twins_signature_parity(pkg):
    """Every public ``*_ref`` oracle in ``<pkg>/ref.py`` has a twin among
    the public functions of ``<pkg>/ops.py`` whose parameters are a
    superset in the same order with the same defaults (FED302's check,
    by the rule's own helpers), or is a recorded exception whose one
    mismatch is pinned."""
    ctx = core.Context(root=REPO_ROOT)
    ref = ctx.source(f"{PORT}kernels/{pkg}/ref.py")
    ops = ctx.source(f"{PORT}kernels/{pkg}/ops.py")
    oracles = {n: f for n, f in _public_functions(ref.tree).items()
               if n.endswith("_ref")}
    twins = _public_functions(ops.tree)
    assert oracles and twins
    for name, fn in sorted(oracles.items()):
        sig = _params(fn)
        matched = [t for t, tf in sorted(twins.items())
                   if _twin_mismatch(sig, _params(tf)) is None]
        exception = TWIN_EXCEPTIONS.get((pkg, name))
        if exception is None:
            assert matched, f"{pkg}/ref.py:{name} has no twin in ops.py"
            continue
        twin, why = exception
        assert not matched, f"{pkg}/{name} now has a twin: drop the exception"
        assert _twin_mismatch(sig, _params(twins[twin])) == why
    # no exception outlives its oracle
    assert {n for p, n in TWIN_EXCEPTIONS if p == pkg} <= set(oracles)


# =========================================================================
# the retargeting bites: one injected violation per rule
# =========================================================================

# (rule, port file copied, code appended to it, expected finding ID); the
# violations are those of tests/fixtures/fedlint/
INJECTED = [
    ("lock-discipline", "core/store.py",
     "def _probe(rec):\n    rec.custody = None\n", "FED102"),
    ("lock-discipline", "core/transport.py",
     "def _probe(t):\n    return t.tx_bytes\n", "FED101"),
    ("lock-order", "core/store.py",
     "class _Probe:\n"
     "    def ab(self):\n"
     "        with self.a_lock:\n"
     "            with self.b_lock:\n"
     "                pass\n\n"
     "    def ba(self):\n"
     "        with self.b_lock:\n"
     "            with self.a_lock:\n"
     "                pass\n", "FED201"),
    ("determinism", "core/fedccl.py",
     "def _probe():\n    return time.time()\n", "FED503"),
    ("determinism", "core/store.py",
     "def _probe(n):\n    return np.random.rand(n)\n", "FED501"),
    ("determinism", "obs/record.py",
     "def _probe(keys):\n    return [k for k in set(keys)]\n", "FED504"),
    ("epoch-routing", "core/store.py",
     "def _probe(key, n):\n    return stable_shard(key, n)\n", "FED404"),
    ("epoch-routing", "launch/shard_server.py",
     "def _probe(self, key):\n    return self.ring.owner(key)\n", "FED404"),
    ("observability", "core/fetch.py",
     "def _probe(x):\n    print(x)\n", "FED601"),
    ("observability", "obs/export.py",
     "def _probe():\n    return time.perf_counter()\n", "FED602"),
    ("wire-drift", "core/transport.py",
     '_PROBE_MSG = ["brandnewop", 0]\n', "FED403"),
]


@pytest.mark.parametrize(
    "name,rel,code,rule_id", INJECTED,
    ids=[f"{r[0]}-{r[3]}-{pathlib.PurePath(r[1]).stem}" for r in INJECTED])
def test_retargeted_rule_finds_injected_violation(
        monkeypatch, tmp_path, name, rel, code, rule_id):
    """A copy of the port's tree in ``tmp_path`` with one violation appended
    to one file: the unpatched rule does not see it (the port is out of the
    reference's scope) and the retargeted rule reports it at that file."""
    (tmp_path / "docs").mkdir()
    shutil.copy(REPO_ROOT / wire.DOC, tmp_path / wire.DOC)
    for sub in ("core", "obs", "launch"):
        shutil.copytree(REPO_ROOT / PORT / sub, tmp_path / PORT / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    target = tmp_path / PORT / rel
    target.write_text(target.read_text() + "\n\n" + code)
    hit = f"{PORT}{rel}"

    def found():
        return [f for f in _run([name], [tmp_path / PORT], root=tmp_path)
                if f.rule == rule_id and f.path == hit]

    assert found() == []
    retarget(monkeypatch)
    assert found(), f"{name} missed {rule_id} injected into {hit}"

"""The port's checkpoint engine and state parity (``checkpoint/``) against
the JAX package's.

The cases of the reference's ``tests/test_checkpoint.py`` run through both
packages from the same seeded state -- jax arrays in the reference, torch
tensors in the port on the CPU -- and everything must be equal, with no
tolerance: the manifest's bytes and catalog, the drive images, L2P,
validity and ``Stats`` after every step, and the restored leaves, which must
also equal the saved ones bit for bit in dtype and shape (a bf16 leaf and an
int32 scalar among them).  The reference runs its jnp datapath
(``use_pallas=False``, its default here) and, for the state parity, the jnp
oracle.  The flattening helper is held to ``jax.tree_util``'s order and
``keystr`` names.

``tests/test_checkpoint.py::test_restart_determinism`` needs the training
stack (optimizer, train step, data pipeline), which the port does not have
yet; it is not mirrored here.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port import JAX, PORT, assert_same_state, cpu
from repro_torch.checkpoint import _tree


def _engine(pkg):
    cfg = pkg.ckpt.CheckpointConfig(n_lanes=4, scheme="raid5", group_size=8, block_bytes=512,
                                    zone_cap_blocks=256, n_zones=64, chunk_blocks=2, **cpu(pkg))
    return pkg.ckpt.CheckpointEngine(cfg, logical_blocks=1 << 13)


def _mk_state(pkg, seed=0, n=3):
    """``tests/test_checkpoint.py``'s state: f32 weights, an int32 scalar
    step and a bf16 moment, as jax arrays or torch tensors of equal bits."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((8, 16)).astype(np.float32) for _ in range(n)]
    mom = rng.standard_normal(64).astype(np.float32)
    if pkg is JAX:
        return {"params": {f"w{i}": jnp.asarray(w) for i, w in enumerate(ws)},
                "step": jnp.int32(seed), "m": {"w0": jnp.asarray(mom, jnp.bfloat16)}}
    return {"params": {f"w{i}": torch.from_numpy(w) for i, w in enumerate(ws)},
            "step": torch.tensor(seed, dtype=torch.int32),
            "m": {"w0": torch.from_numpy(mom).to(torch.bfloat16)}}


def _bits(leaf) -> tuple:
    """A leaf's (dtype name, shape, bytes)."""
    if isinstance(leaf, torch.Tensor):
        return (str(leaf.dtype).removeprefix("torch."), tuple(leaf.shape),
                leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(leaf)
    return str(a.dtype), a.shape, a.tobytes()


def _same_tree_bits(ref_tree, port_tree) -> None:
    fa, _ = _tree.flatten_with_path(ref_tree)
    fb, _ = _tree.flatten_with_path(port_tree)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, a), (_, b) in zip(fa, fb):
        assert _bits(a) == _bits(b), name


def _same_engines(ea, eb) -> None:
    assert ea.catalog == eb.catalog
    assert ea._alloc_ptr == eb._alloc_ptr and ea.saves == eb.saves
    assert np.array_equal(ea._manifest_blocks(), eb._manifest_blocks())
    assert ea.stats() == eb.stats()
    assert_same_state(ea.array, eb.array)


def _restored(eb, step, state):
    """The port's restore of ``step``: tensors equal to ``state`` in dtype,
    shape and bits."""
    out = eb.restore(step, state)
    for (_, want), (_, got) in zip(_tree.flatten_with_path(state)[0],
                                   _tree.flatten_with_path(out)[0]):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    return out


def _both(run):
    """``run(pkg)`` -> (engine, restored tree) in each package; engines and
    restored leaves equal.  Returns the port's engine."""
    (ea, ra), (eb, rb) = run(JAX), run(PORT)
    _same_engines(ea, eb)
    _same_tree_bits(ra, rb)
    return eb


def test_save_restore_roundtrip_matches_reference():
    def run(pkg):
        eng, state = _engine(pkg), _mk_state(pkg, 1)
        eng.save(10, state)
        out = _restored(eng, 10, state) if pkg is PORT else eng.restore(10, state)
        return eng, out

    eng = _both(run)
    names = list(eng.catalog[10]["leaves"])
    assert names == ["['m']['w0']", "['params']['w0']", "['params']['w1']",
                     "['params']['w2']", "['step']"]
    assert eng.catalog[10]["leaves"]["['m']['w0']"]["dtype"] == "bfloat16"
    assert eng.catalog[10]["leaves"]["['step']"]["shape"] == []


def test_retirement_matches_reference():
    def run(pkg):
        eng = _engine(pkg)
        states = {s: _mk_state(pkg, s) for s in (1, 2, 3, 4)}
        for s, st in states.items():
            eng.save(s, st)
        out = _restored(eng, 4, states[4]) if pkg is PORT else eng.restore(4, states[4])
        return eng, out

    assert sorted(_both(run).catalog) == [3, 4]


def test_degraded_restore_matches_reference():
    def run(pkg):
        eng, state = _engine(pkg), _mk_state(pkg, 7)
        eng.save(5, state)
        eng.fail_lane(2)
        out = _restored(eng, 5, state) if pkg is PORT else eng.restore(5, state)
        return eng, out

    assert _both(run).array.stats.degraded_reads > 0


def test_hot_spare_save_matches_reference():
    def run(pkg):
        eng = _engine(pkg)
        eng.save(1, _mk_state(pkg, 1))
        eng.fail_lane(0)
        st2 = _mk_state(pkg, 2)
        eng.save(2, st2)  # rebuilds lane 0 first
        out = _restored(eng, 2, st2) if pkg is PORT else eng.restore(2, st2)
        return eng, out

    assert not _both(run).array.drives[0].failed


def test_crash_remount_matches_reference():
    def run(pkg):
        eng, st = _engine(pkg), _mk_state(pkg, 3)
        eng.save(42, st)
        eng2 = eng.crash_and_remount()
        out = _restored(eng2, 42, st) if pkg is PORT else eng2.restore(42, st)
        return eng2, out

    assert 42 in _both(run).catalog


def test_gc_under_many_saves_matches_reference():
    def run(pkg):
        eng = _engine(pkg)
        for s in range(1, 14):
            eng.save(s, _mk_state(pkg, s))
        last = max(eng.catalog)
        want = _mk_state(pkg, last)
        out = _restored(eng, last, want) if pkg is PORT else eng.restore(last, want)
        return eng, out

    eng = _both(run)
    assert max(eng.catalog) == 13 and eng.array.stats.device_blocks_written > 0


def test_numpy_and_scalar_leaves_round_trip_as_reference():
    """numpy leaves come back as numpy; a Python int is an int64 of shape
    [], a float a float64; ``None`` holds no leaf; a degraded restore after a
    crash remount."""
    rng = np.random.default_rng(4)
    state = {"a": rng.standard_normal((3, 5)).astype(np.float32), "n": 7, "x": 2.5,
             "t": (np.arange(5, dtype=np.int16), None, [np.uint8(3)])}

    def run(pkg):
        eng = _engine(pkg)
        eng.save(1, state)
        eng.fail_lane(1)
        eng2 = eng.crash_and_remount()
        return eng2, eng2.restore(1, state)

    eng = _both(run)
    out = eng.restore(1, state)
    leaves = eng.catalog[1]["leaves"]
    assert leaves["['n']"]["dtype"] == "int64" and leaves["['n']"]["shape"] == []
    assert leaves["['x']"]["dtype"] == "float64"
    assert out["t"][1] is None and isinstance(out["a"], np.ndarray)
    assert np.array_equal(out["a"], state["a"]) and out["n"] == 7 and out["x"] == 2.5


# ------------------------------------------------------------- flattening

def test_flatten_order_and_names_match_jax():
    nt = collections.namedtuple("NT", "x y")
    tree = {
        **{f"layer{i}": np.full(2, i, np.float32) for i in range(12)},
        "nested": [1, (2.0, None, np.zeros(3)), [[np.int8(4)]]],
        "od": collections.OrderedDict([("z", 1), ("a", 2)]),
        "none": None,
        "nt": nt(np.ones(1), [5, 6]),
        "t": torch.arange(3, dtype=torch.int32),
    }
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, tree))[0]
    flat, treedef = _tree.flatten_with_path(tree)
    assert [n for n, _ in flat] == [jax.tree_util.keystr(p) for p, _ in ref]
    assert [n for n, _ in flat][:4] == ["['layer0']", "['layer1']", "['layer10']", "['layer11']"]
    for (_, a), (_, b) in zip(flat, ref):
        assert _tree.leaf_meta(a) == (str(np.asarray(b).dtype), list(np.shape(b)),
                                      np.asarray(b).nbytes)
    back = _tree.unflatten(treedef, [leaf for _, leaf in flat])
    assert list(back) == sorted(tree) and list(back["od"]) == ["z", "a"]
    assert back["none"] is None and back["nested"][1][1] is None
    assert isinstance(back["nested"][1], tuple) and isinstance(back["nt"], nt)
    with pytest.raises(TypeError):
        _tree.flatten_with_path({1: 0, "a": 0})


# ------------------------------------------------------------ state parity

def _shards(pkg, k=4, seed=0):
    rng = np.random.default_rng(seed)
    raw = [{"m": rng.standard_normal((16, 8)).astype(np.float32),
            "v": rng.standard_normal(33).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "q": rng.integers(0, 256, 5).astype(np.uint8)} for _ in range(k)]
    if pkg is JAX:
        return [{n: jnp.asarray(a) if n != "b" else jnp.asarray(a, jnp.bfloat16)
                 for n, a in s.items()} for s in raw]
    return [{n: torch.from_numpy(a) if n != "b" else torch.from_numpy(a).to(torch.bfloat16)
             for n, a in s.items()} for s in raw]


@pytest.mark.parametrize("m", [1, 2])
def test_state_parity_matches_reference(m):
    k, lost = 4, 2
    out = {}
    for pkg in (JAX, PORT):
        shards = _shards(pkg, k)
        if pkg is JAX:
            parity = pkg.parity.encode_shards(shards, m=m, use_pallas=False)
        else:
            parity = pkg.parity.encode_shards(shards, m=m)
        surviving = {r: shards[r] for r in range(k) if r != lost}
        kw = {"use_pallas": False} if pkg is JAX else {}
        rec = pkg.parity.reconstruct_shard(lost, surviving, parity, k, **kw)
        out[pkg.name] = (parity, rec, shards)
    (pa, ra, _), (pb, rb, shards) = out["jax"], out["torch"]
    assert len(pa) == len(pb) == m
    for a, b in zip(pa, pb):
        _same_tree_bits(a, b)
        assert all(v.dtype == torch.uint8 and v.numel() % 4 == 0 for v in b.values())
    _same_tree_bits(ra, rb)
    for name, leaf in shards[lost].items():
        assert rb[name].dtype == leaf.dtype and torch.equal(rb[name], leaf)
    if m == 2:  # two ranks lost: both parity rows stand in
        rec = PORT.parity.reconstruct_shard(1, {0: shards[0], 3: shards[3]}, pb, k)
        for name, leaf in shards[1].items():
            assert torch.equal(rec[name], leaf)

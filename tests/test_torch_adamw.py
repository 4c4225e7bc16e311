"""The port's AdamW and gradient compressors against the JAX package's.

Both packages get the same parameters, gradients and state (numpy, seeded),
so the update is compared apart from the gradients themselves (the loss's
gradients are held in ``test_torch_train.py``).  Tolerances: the global
norm sums the leaves' squares in the reference's order, each leaf reduced
in another order than XLA's, so the norm agrees to 1e-6 relative, and the
clip scale with it; the updated f32 masters and moments agree to 1e-6 of
each leaf's largest value (``b1 m + (1 - b1) g`` cancels where m and g
have opposite signs, and there an ulp of the scale is a larger share of the
result than of the leaf); a bf16 parameter is the master rounded once, equal
but where the two masters round to neighbouring bf16 values (one ulp).
The compressors are exact: int8 rounds half to even in both (``jnp.round``,
``torch.round``), top-k compares against the same f32 threshold within an
ulp, so the kept set is checked and values equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.optim import adamw as jadamw
from repro_torch.distributed import compression as tcomp
from repro_torch.optim import adamw as tadamw

RTOL = 1e-6


def _trees(seed, dtype):
    """Params (``dtype``), grads of mixed scale and a warmed state, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "layers": {"w": (2, 8, 12), "ln": (2, 8)}, "lm_head": (8, 16)}

    def tree(fn):
        return {k: tree_of(v, fn) for k, v in shapes.items()}

    def tree_of(v, fn):
        return {k: fn(s) for k, s in v.items()} if isinstance(v, dict) else fn(v)

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(
        np.float32))
    master = jax.tree.map(lambda p: p.copy(), params)
    m = tree(lambda s: (0.01 * rng.standard_normal(s)).astype(np.float32))
    v = tree(lambda s: (1e-4 * rng.random(s)).astype(np.float32))
    if dtype == "bfloat16":
        params = jax.tree.map(lambda p: np.asarray(jnp.asarray(p, jnp.bfloat16)), params)
        master = jax.tree.map(lambda p: p.astype(np.float32), params)
    return params, grads, master, m, v


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype or torch.float32), tree)


def _close(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("step", [0, 3, 9, 50])
def test_apply_updates_matches_reference(dtype, clip, step):
    params, grads, master, m, v = _trees(step + 7, dtype)
    cfg = dict(grad_clip=clip, warmup_steps=10, lr=1e-3)
    jstate = {"step": jnp.int32(step), "master": master, "m": m, "v": v}
    jp = jax.tree.map(jnp.asarray, params)
    jnew, jst, jmet = jadamw.apply_updates(jadamw.AdamWConfig(**cfg), jp,
                                           jax.tree.map(jnp.asarray, grads), jstate)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tstate = {"step": torch.tensor(step, dtype=torch.int32), "master": _to_torch(master),
              "m": _to_torch(m), "v": _to_torch(v)}
    tnew, tst, tmet = tadamw.apply_updates(tadamw.AdamWConfig(**cfg), _to_torch(params, tdt),
                                           _to_torch(grads), tstate)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=RTOL)
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(tst["step"]) == int(jst["step"]) == step + 1
    assert tst["step"].dtype == torch.int32
    for key in ("master", "m", "v"):
        _close(tst[key], jst[key], key)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                            jax.tree.leaves(tnew, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert g.dtype == tdt
        w32, g32 = np.asarray(w, np.float32), g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g32, w32, rtol=RTOL, atol=RTOL * np.abs(w32).max())
        else:  # one rounding of masters within RTOL: equal or one bf16 ulp apart
            ulp = np.abs(w32) * 2.0 ** -7
            assert np.all(np.abs(g32 - w32) <= ulp), jax.tree_util.keystr(path)


def test_init_state_matches_reference():
    params, *_ = _trees(0, "bfloat16")
    want = jadamw.init_state(jax.tree.map(jnp.asarray, params))
    got = tadamw.init_state(_to_torch(params, torch.bfloat16))
    assert set(got) == set(want) == {"step", "master", "m", "v"}
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for key in ("master", "m", "v"):
        for w, g in zip(jax.tree.leaves(want[key]),
                        jax.tree.leaves(got[key], is_leaf=lambda x: isinstance(x, torch.Tensor))):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_with_error_feedback_matches_reference(kind, seed):
    rng = np.random.default_rng(seed)
    grads = {"a": rng.standard_normal((64, 33)).astype(np.float32),
             "b": {"c": (rng.standard_normal(257) * 1e-3).astype(np.float32)}}
    resid = {"a": (0.01 * rng.standard_normal((64, 33))).astype(np.float32),
             "b": {"c": np.zeros(257, np.float32)}}
    jg, jr = jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, resid)
    tg, tr = _to_torch(grads), _to_torch(resid)
    for _ in range(3):  # the residual carries over
        jg2, jr = jcomp.apply_compression(jg, jr, kind)
        tg2, tr = tcomp.apply_compression(tg, tr, kind)
        for w, g in zip(jax.tree.leaves(jg2),
                        jax.tree.leaves(tg2, is_leaf=lambda x: isinstance(x, torch.Tensor))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for w, g in zip(jax.tree.leaves(jr),
                        jax.tree.leaves(tr, is_leaf=lambda x: isinstance(x, torch.Tensor))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["compress_int8", "compress_topk"])
def test_compressors_match_reference_on_ties_and_bf16(fn):
    """Values at exact .5 steps of the int8 scale (round half to even) and a
    bf16 gradient."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.0, 0.0] * 4, np.float32)
    for arr in (g, np.asarray(jnp.asarray(g * 0.37, jnp.bfloat16))):
        want = getattr(jcomp, fn)(jnp.asarray(arr))
        tdt = torch.bfloat16 if arr.dtype != np.float32 else torch.float32
        got = getattr(tcomp, fn)(torch.from_numpy(arr.astype(np.float32)).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

"""The port's layer functions against the JAX package's ``models/layers.py``.

Weights come from the reference's init functions (``PRNGKey`` seeded) and
activations from numpy seeds; both go through each package's function on
the CPU.  Tolerances: 2e-5 in float32 (sums in another order), 3e-2 in
bf16 (the frameworks round at other places), the JAX suite's own kernel
tolerances (``tests/test_kernels.py``).  MoE dispatch -- which slots are kept
and where they go -- must be equal exactly, including where capacity binds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port import to_torch
from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models.config import smoke as j_smoke
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.config import smoke

F32, BF16 = 2e-5, 3e-2


def _cfgs(arch, **kw):
    return j_smoke(j_get_config(arch), **kw), smoke(get_config(arch), **kw)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _both(arr, dtype="float32"):
    """One numpy array as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(arr, dtype),
            torch.from_numpy(arr).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32))


@pytest.mark.parametrize("theta,start", [(10000.0, 0), (1e6, 37)])
def test_rope(theta, start):
    x = _normal(0, 2, 6, 3, 16)
    pos = np.broadcast_to(np.arange(start, start + 6), (2, 6))
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), theta), F32)


def _qkv_arrays(seed, t, s=None, h=4, kv=2, hd=16):
    s = s or t
    return _normal(seed, 2, t, h, hd), _normal(seed + 1, 2, s, kv, hd), \
        _normal(seed + 2, 2, s, kv, hd)


@pytest.mark.parametrize("t,q_block,attn_chunk", [
    (16, 512, 0),   # one block
    (16, 4, 0),     # four blocks
    (12, 8, 0),     # ragged: 12 has no divisor 8, the blocks are of 6
    (13, 4, 0),     # prime: blocks of 1
    (16, 4, 4),     # llama4's local chunks
    (12, 5, 6),     # ragged blocks across chunk edges
])
def test_blocked_causal_attention(t, q_block, attn_chunk):
    q, k, v = _qkv_arrays(t, t)
    got = tl.blocked_causal_attention(*map(torch.from_numpy, (q, k, v)), q_block=q_block,
                                      attn_chunk=attn_chunk)
    want = jl.blocked_causal_attention(*map(jnp.asarray, (q, k, v)), q_block=q_block,
                                       attn_chunk=attn_chunk)
    _close(got, want, F32)


@pytest.mark.parametrize("cache_len,attn_chunk", [(1, 0), (7, 0), (10, 0), (9, 4), (10, 3)])
def test_decode_attention(cache_len, attn_chunk):
    q, k, v = _qkv_arrays(cache_len, 1, s=10)
    got = tl.decode_attention(*map(torch.from_numpy, (q, k, v)), cache_len,
                              attn_chunk=attn_chunk)
    want = jl.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(cache_len),
                               attn_chunk=attn_chunk)
    _close(got, want, F32)


def _attention_case(arch, dtype, **kw):
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **kw)
    p, _ = jl.init_attention(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, p, to_torch(p)


@pytest.mark.parametrize("arch,dtype,tol,kw", [
    ("qwen2.5-3b", "float32", F32, {}),                      # qkv bias
    ("smollm-135m", "float32", F32, {}),                     # no bias
    ("llama4-scout-17b-a16e", "float32", F32, {"attn_chunk": 4}),
    ("qwen2.5-3b", "bfloat16", BF16, {}),
], ids=["qwen-f32", "smollm-f32", "llama4-chunk-f32", "qwen-bf16"])
def test_attention_apply_prefill_then_decode(arch, dtype, tol, kw):
    jcfg, tcfg, jp, tp = _attention_case(arch, dtype, **kw)
    b, t, s = 2, 10, 13
    jx, tx = _both(_normal(2, b, t, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(t), (b, t))
    jy, (jk, jv) = jl.attention_apply(jp, jx, jcfg, positions=jnp.asarray(pos), q_block=4)
    ty, (tk, tv) = tl.attention_apply(tp, tx, tcfg, positions=torch.from_numpy(pos.copy()),
                                      q_block=4)
    assert ty.dtype == tx.dtype
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, tol)
    # decode into a cache of s positions holding the prefill's t
    pad = ((0, 0), (0, s - t), (0, 0), (0, 0))
    jkc, jvc = jnp.pad(jk, pad), jnp.pad(jv, pad)
    tkc = torch.zeros((b, s, *tk.shape[2:]), dtype=tk.dtype)
    tvc = torch.zeros_like(tkc)
    tkc[:, :t], tvc[:, :t] = tk, tv
    for i in range(s - t):
        jx, tx = _both(_normal(3 + i, b, 1, jcfg.d_model), dtype)
        n = t + i + 1
        pos = np.full((b, 1), n - 1)
        jy, (jkc, jvc) = jl.attention_apply(jp, jx, jcfg, positions=jnp.asarray(pos),
                                            kv_cache=(jkc, jvc), cache_len=jnp.int32(n))
        ty, _ = tl.attention_apply(tp, tx, tcfg, positions=torch.from_numpy(pos),
                                   kv_cache=(tkc, tvc), cache_len=n)
        _close(ty, jy, tol)
        _close(tkc, jkc, tol)  # written in place
        _close(tvc, jvc, tol)


def test_attention_apply_refuses_a_full_cache_and_the_mesh_flags():
    jcfg, tcfg, _, tp = _attention_case("qwen2.5-3b", "float32")
    kc = torch.zeros((1, 3, tcfg.n_kv_heads, tcfg.hd()))
    x = torch.zeros((1, 1, tcfg.d_model))
    with pytest.raises(ValueError, match="no room"):
        tl.attention_apply(tp, x, tcfg, positions=torch.zeros((1, 1)), kv_cache=(kc, kc.clone()),
                           cache_len=4)
    # off a mesh the sharding flags change nothing, as in the reference
    # (no ambient mesh: the blocked attention, no weight gather)
    xs = torch.from_numpy(_normal(6, 2, 8, tcfg.d_model))
    pos = torch.arange(8).expand(2, 8)
    want, _ = tl.attention_apply(tp, xs, tcfg, positions=pos)
    for flag in ("attn_seq_shard", "fsdp_gather"):
        _, cfg = _cfgs("qwen2.5-3b", **{flag: True})
        got, _ = tl.attention_apply(tp, xs, cfg, positions=pos)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("gated,dtype,tol", [(True, "float32", F32), (False, "float32", F32),
                                             (True, "bfloat16", BF16),
                                             (False, "bfloat16", BF16)])
def test_mlp_apply(gated, dtype, tol):
    """SwiGLU, and the encoder-decoder's GELU (tanh approximation, as
    ``jax.nn.gelu`` computes by default; the exact erf form differs by up
    to ~1e-3 and would fail at 2e-5)."""
    jcfg, _ = _cfgs("whisper-small" if not gated else "qwen2.5-3b", dtype=dtype)
    p, _ = jl.init_mlp(jax.random.PRNGKey(4), jcfg, gated=gated)
    jx, tx = _both(_normal(5, 2, 7, jcfg.d_model, scale=2.0), dtype)
    got = tl.mlp_apply(to_torch(p), tx)
    assert got.dtype == tx.dtype
    _close(got, jl.mlp_apply(p, jx), tol)


def _reference_moe(monkeypatch, p, x, cfg):
    """The reference's ``moe_apply`` output and its dispatch, read from the
    arguments of its two ``jax.vmap`` calls (scatter: x, token_of, slot;
    gather: out, slot, sorted_p, keep, token_of)."""
    calls = []
    real = jax.vmap

    def spy(fn, *a, **k):
        mapped = real(fn, *a, **k)

        def call(*args):
            calls.append(args)
            return mapped(*args)
        return call

    monkeypatch.setattr(jax, "vmap", spy)
    y = jl.moe_apply(p, x, cfg)
    monkeypatch.setattr(jax, "vmap", real)
    (_, token_of, slot), (_, slot2, probs, keep, _) = calls
    assert np.array_equal(slot, slot2)
    return y, {"token_of": np.asarray(token_of), "slot": np.asarray(slot),
               "keep": np.asarray(keep) > 0, "probs": np.asarray(probs)}


@pytest.mark.parametrize("arch,kw,binds", [
    ("llama4-scout-17b-a16e", {}, None),                    # top-1 + shared expert
    ("grok-1-314b", {}, None),                              # top-2
    ("grok-1-314b", {"capacity_factor": 0.5}, True),        # capacity binds
    ("llama4-scout-17b-a16e", {"capacity_factor": 0.5}, True),
])
def test_moe_apply_and_its_dispatch(monkeypatch, arch, kw, binds):
    jcfg, tcfg = _cfgs(arch, **kw)
    p, _ = jl.init_moe(jax.random.PRNGKey(6), jcfg)
    x = _normal(7, 2, 32, jcfg.d_model)
    want, dsp = _reference_moe(monkeypatch, p, jnp.asarray(x), jcfg)
    tp = to_torch(p)
    got = tl.moe_dispatch(tp["router"], torch.from_numpy(x), tcfg)
    assert np.array_equal(got.token_of.numpy(), dsp["token_of"])
    assert np.array_equal(got.slot.numpy(), dsp["slot"])
    assert np.array_equal(got.keep.numpy(), dsp["keep"])
    _close(got.probs, dsp["probs"], F32)
    if binds:
        assert not dsp["keep"].all()  # some slots dropped at the sentinel row
        assert (dsp["slot"][~dsp["keep"]] == jcfg.n_experts * got.cap).all()
    _close(tl.moe_apply(tp, torch.from_numpy(x), tcfg), want, F32)


def test_moe_dispatch_sorts_stably():
    """Slots of one expert keep their token order (``jnp.argsort`` is
    stable): with every token routed to one expert, the kept ones are the
    first ``cap`` tokens."""
    _, cfg = _cfgs("llama4-scout-17b-a16e")
    router = torch.zeros((cfg.d_model, cfg.n_experts))
    router[:, 2] = 1.0
    x = torch.ones((1, 40, cfg.d_model))
    dsp = tl.moe_dispatch(router, x, cfg)
    assert dsp.token_of.tolist() == [list(range(40))]
    assert dsp.keep[0].tolist() == [True] * dsp.cap + [False] * (40 - dsp.cap)
    assert dsp.slot[0, : dsp.cap].tolist() == [2 * dsp.cap + i for i in range(dsp.cap)]

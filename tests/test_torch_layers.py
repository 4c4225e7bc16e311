"""The port's layer functions against the JAX package's ``models/layers.py``.

Weights come from the reference's init functions (``PRNGKey`` seeded) and
activations from numpy seeds; both go through each package's function on
the CPU.  Tolerances: 2e-5 in float32 (sums in another order), 3e-2 in
bf16 (the frameworks round at other places), the JAX suite's own kernel
tolerances (``tests/test_kernels.py``).  MoE dispatch -- which slots are kept
and where they go -- must be equal exactly, including where capacity binds.
The dropless MoE, NoPE and the attention ``scale``, which the JAX package
lacks, are held to ``port_bench/reference/granite_hybrid.py`` (plain float32)
and to the JAX functions on queries scaled by hand.
"""
import dataclasses
import sys
from pathlib import Path

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


# ------------------------------------------- dropless MoE, NoPE and scale

def _granite_reference():
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from port_bench.reference import granite_hybrid

    return granite_hybrid


def _skewed_moe(seed: int = 8):
    """granite's smoke MoE (8 experts, 4 per token) with a router that sends
    every token to experts 0-3 (their columns raised, the input positive),
    and its input (2, 24, d)."""
    cfg = smoke(get_config("granite-4.0-h-small"))
    gen = torch.Generator().manual_seed(seed)
    p = tl.init_moe(gen, cfg, device="cpu")
    p["router"][:, :4] += 1.0
    x = torch.from_numpy(np.abs(_normal(seed, 2, 24, cfg.d_model)) + 0.5)
    return cfg, p, x


def test_dropless_moe_drops_no_slot_where_capacity_would():
    """With every token routed to the same 4 of 8 experts, the capacity path
    (``capacity_factor`` 1.25) drops slots; the dropless path computes all
    of them and matches the published routing (top-k logits, softmax over
    them) of the plain reference, token by token."""
    ref = _granite_reference()
    cfg, p, x = _skewed_moe()
    capped = dataclasses.replace(cfg, moe_dropless=False)
    assert not bool(tl.moe_dispatch(p["router"], x, capped).keep.all())
    got = tl.moe_apply(p, x, cfg)
    s = ref.Shape.of(dataclasses.asdict(cfg))
    for r in range(2):
        _close(got[r], ref.moe(p, x[r], s), F32)
    assert not torch.allclose(tl.moe_apply(p, x, capped), got, atol=1e-3)


def test_dropless_and_capacity_agree_where_nothing_drops():
    """A capacity large enough for every slot keeps them all: the two paths
    compute the same sums (in another order and precision)."""
    cfg, p, x = _skewed_moe(9)
    p["router"][:, :4] -= 1.0  # the init's routing, spread over the experts
    roomy = dataclasses.replace(cfg, moe_dropless=False, capacity_factor=float(cfg.n_experts))
    assert bool(tl.moe_dispatch(p["router"], x, roomy).keep.all())
    _close(tl.moe_apply(p, x, cfg), tl.moe_apply(p, x, roomy), F32)


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_capacity_path_is_the_default_and_bit_equal_with_the_switch_off(arch):
    cfg = smoke(get_config(arch))
    assert cfg.moe_dropless is False
    p = tl.init_moe(torch.Generator().manual_seed(3), cfg, device="cpu")
    x = torch.from_numpy(_normal(3, 2, 16, cfg.d_model))
    assert torch.equal(tl.moe_apply(p, x, cfg),
                       tl.moe_apply(p, x, dataclasses.replace(cfg, moe_dropless=False)))


@pytest.mark.parametrize("scale", [1 / 128, 0.3])
def test_scale_through_the_blocked_and_decode_paths(scale):
    """Scaling the scores by ``scale`` is the reference's attention of
    queries multiplied by ``scale / hd ** -0.5``."""
    q, k, v = _qkv_arrays(21, 12)
    hd = q.shape[-1]
    qs = q * np.float32(scale * hd ** 0.5)
    got = tl.blocked_causal_attention(*map(torch.from_numpy, (q, k, v)), q_block=4, scale=scale)
    _close(got, jl.blocked_causal_attention(*map(jnp.asarray, (qs, k, v)), q_block=4), F32)
    q1, k1, v1 = _qkv_arrays(22, 1, s=10)
    q1s = q1 * np.float32(scale * hd ** 0.5)
    got = tl.decode_attention(*map(torch.from_numpy, (q1, k1, v1)), 7, scale=scale)
    _close(got, jl.decode_attention(*map(jnp.asarray, (q1s, k1, v1)), jnp.int32(7)), F32)


def test_nope_attention_apply_prefill_then_decode():
    """granite's attention (no positional embedding, scale 1/128): the
    prefill is the blocked attention of unrotated q and k at that scale, and
    decoding position 7 from a cache of the first 7 gives the prefill's row."""
    cfg = smoke(get_config("granite-4.0-h-small"))
    assert not cfg.use_rope and cfg.attn_scale == 1 / 128
    p = tl.init_attention(torch.Generator().manual_seed(5), cfg, device="cpu")
    x = torch.from_numpy(_normal(6, 2, 8, cfg.d_model))
    pos = torch.arange(8)[None].expand(2, 8)
    y, (k, v) = tl.attention_apply(p, x, cfg, positions=pos)
    q, wk, wv = tl._qkv(p, x, cfg)
    assert torch.equal(k, wk) and torch.equal(v, wv)  # no rotary
    want = tl.merge_heads(tl.blocked_causal_attention(q, wk, wv, q_block=512, scale=1 / 128))
    _close(y, want @ p["wo"], F32)
    shifted, _ = tl.attention_apply(p, x, cfg, positions=pos + 5)
    assert torch.equal(shifted, y)  # positions do not enter
    kc = torch.zeros((2, 8, cfg.n_kv_heads, cfg.hd()))
    vc = torch.zeros_like(kc)
    kc[:, :7], vc[:, :7] = k[:, :7], v[:, :7]
    y7, _ = tl.attention_apply(p, x[:, 7:8], cfg, positions=pos[:, 7:8], kv_cache=(kc, vc),
                               cache_len=8)
    _close(y7[:, 0], y[:, 7], F32)

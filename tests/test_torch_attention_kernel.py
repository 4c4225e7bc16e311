"""Prefill's causal attention kernel (``kernels/attention.py`` over
``csrc/attention.cu``) and the routing in ``models/layers.py``.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one: they hold
the kernel to ``blocked_causal_attention`` in bf16 and check that
``attention_apply`` takes it where ``kernels/route.py``'s rule lets it, at
``smoke()``'s head dim of 16 too, and raises for a head dim without an
instance.  The others run on the CPU: the wrapper refuses what the kernel
does not take (``tests/test_torch_kernel_route.py`` holds the CPU route).
The file imports neither JAX nor ``repro``.  Run the card's tests with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_kernel.py
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import attention as attn
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import layers as L
from repro_torch.models.config import smoke

# Both outputs are bf16 roundings of f32 sums whose weights were rounded to
# bf16 at two points (the kernel rounds the unnormalised weights, the
# blocked function the normalised ones), each within 2^-9 of the weight:
# before the last rounding they lie within 2^-8 of sum_j w_j |v_j| <= max|v|
# of each other (ATOL, times max|v|), and the last rounding adds at most one
# ulp, 2^-7 of the value (RTOL).
RTOL, ATOL = 2.0 ** -7, 2.0 ** -8

# (batch, t, heads, kv heads, head dim, s, q_offset, attn_chunk)
CASES = {
    "zamba2": (2, 1024, 32, 32, 80, 1024, 0, 0),  # the shared block, batch and T cut
    "hd16": (2, 200, 4, 2, 16, 200, 0, 0),  # smoke()'s head dim
    "hd64": (2, 512, 8, 8, 64, 512, 0, 0),
    "hd128": (2, 512, 16, 16, 128, 512, 0, 0),
    "hd256": (1, 384, 8, 8, 256, 384, 0, 0),
    "gqa4": (2, 512, 16, 4, 80, 512, 0, 0),  # H / KV = 4
    "ragged": (2, 1000, 8, 2, 80, 1000, 0, 0),  # T not a multiple of any tile
    "offset": (2, 512, 16, 4, 128, 768, 256, 0),  # queries after a cached prefix
    "chunk256": (2, 1024, 8, 2, 128, 1024, 0, 256),  # llama4's local chunks
    # rows 28-63 sit in a chunk with no key: the reference spreads them over all S
    "no_key_in_chunk": (1, 64, 4, 4, 64, 64, 100, 128),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _within(got, want, v):
    err = (got.float() - want.float()).abs()
    lim = RTOL * want.float().abs() + ATOL * v.float().abs().max()
    assert bool((err <= lim).all()), f"worst error {float(err.max())}, limit {float(lim.min())}"


def _attention(dtype: str, head_dim: int, device):
    """A smoke attention block of zamba2-2.7b's family, its input and
    positions."""
    cfg = smoke(get_config("zamba2-2.7b"), head_dim=head_dim, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(5)
    p = L.init_attention(gen, cfg, device=device)
    x = _normal(gen, 2, 40, cfg.d_model, dtype=L.dtype_of(cfg))
    pos = torch.arange(40, device=device)[None].expand(2, 40)
    return cfg, p, x, pos


def _blocked_apply(p, x, cfg, pos):
    """``attention_apply``'s prefill with the blocked function written out."""
    q, k, v = L._qkv(p, x, cfg)
    q, k = L.rope(q, pos, cfg.rope_theta), L.rope(k, pos, cfg.rope_theta)
    out = L.blocked_causal_attention(q, k, v, q_block=512, attn_chunk=cfg.attn_chunk)
    return L.merge_heads(out) @ p["wo"], (k, v)


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_the_blocked_function(cuda, case):
    b, t, h, kvh, hd, s, off, chunk = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(hd + t)
    q, k, v = _normal(gen, b, t, h, hd), _normal(gen, b, s, kvh, hd), _normal(gen, b, s, kvh, hd)
    reset_launch_counts()
    got = attn.causal_attention(q, k, v, q_offset=off, attn_chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["causal_attention"] == 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _within(got, L.blocked_causal_attention(q, k, v, q_block=512, q_offset=off,
                                            attn_chunk=chunk), v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["granite", "granite_offset"])
def test_kernel_takes_a_scale(cuda, case):
    """granite-4.0-h's attention: head dim 128, 32 query heads over 8 K/V heads
    (H / KV = 4) and the softmax scale 1/128 that it publishes in place of
    128 ** -0.5, held to the blocked function at that scale."""
    b, t, h, kvh, hd, s, off = {"granite": (2, 1024, 32, 8, 128, 1024, 0),
                                "granite_offset": (1, 512, 32, 8, 128, 768, 256)}[case]
    gen = torch.Generator(device=cuda).manual_seed(t + off)
    q, k, v = _normal(gen, b, t, h, hd), _normal(gen, b, s, kvh, hd), _normal(gen, b, s, kvh, hd)
    got = attn.causal_attention(q, k, v, q_offset=off, scale=1 / 128)
    torch.cuda.synchronize()
    _within(got, L.blocked_causal_attention(q, k, v, q_block=512, q_offset=off, scale=1 / 128), v)
    default = attn.causal_attention(q, k, v, q_offset=off)
    assert not torch.equal(got, default)


@pytest.mark.cuda
def test_a_nope_prefill_takes_the_kernel_at_its_scale(cuda):
    """``attention_apply`` of a NoPE config with ``attn_scale``, in bf16 under
    no_grad: one kernel launch, matching the blocked path without rotary
    embeddings at the config's scale."""
    cfg = smoke(get_config("granite-4.0-h-small"), head_dim=128, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = L.init_attention(gen, cfg, device=cuda)
    x = _normal(gen, 2, 40, cfg.d_model)
    pos = torch.arange(40, device=cuda)[None].expand(2, 40)
    reset_launch_counts()
    with torch.no_grad():
        y, (k, v) = L.attention_apply(p, x, cfg, positions=pos)
        q, wk, wv = L._qkv(p, x, cfg)
        out = L.blocked_causal_attention(q, wk, wv, q_block=512, scale=cfg.attn_scale)
        want = L.merge_heads(out) @ p["wo"]
    torch.cuda.synchronize()
    assert launch_counts()["causal_attention"] == 1
    assert torch.equal(k, wk) and torch.equal(v, wv)
    _within(y, want, v)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prefill", "recorded", "weight_grad", "float32"])
def test_attention_apply_takes_the_kernel_only_where_nothing_records(cuda, mode):
    """A bf16 prefill under no_grad launches the kernel once and matches the
    blocked path; a recorded graph (every weight, or only ``wq``, requiring
    grad) or a float32 model takes the blocked path and launches nothing
    (the recorded ones back-propagate through it)."""
    cfg, p, x, pos = _attention("float32" if mode == "float32" else "bfloat16", 80, cuda)
    recorded = mode in ("recorded", "weight_grad")
    for name, w in p.items():
        w.requires_grad_(mode == "recorded" or (mode == "weight_grad" and name == "wq"))
    reset_launch_counts()
    with torch.set_grad_enabled(recorded):
        y, (k, v) = L.attention_apply(p, x, cfg, positions=pos)
        want, _ = _blocked_apply(p, x, cfg, pos)
    torch.cuda.synchronize()
    assert launch_counts()["causal_attention"] == (1 if mode == "prefill" else 0)
    if mode == "prefill":
        _within(y, want, v)
    else:
        assert torch.equal(y, want)
    if recorded:
        y.float().sum().backward()
        assert all(w.grad is not None and bool(torch.isfinite(w.grad).all())
                   for w in p.values() if w.requires_grad)


@pytest.mark.cuda
def test_the_smoke_head_dim_takes_the_kernel(cuda):
    """A bf16 prefill under no_grad at ``smoke()``'s head dim of 16 launches
    the kernel once and matches the blocked path."""
    cfg, p, x, pos = _attention("bfloat16", 16, cuda)
    reset_launch_counts()
    with torch.no_grad():
        y, (k, v) = L.attention_apply(p, x, cfg, positions=pos)
        want, (wk, wv) = _blocked_apply(p, x, cfg, pos)
    torch.cuda.synchronize()
    assert launch_counts()["causal_attention"] == 1
    assert torch.equal(k, wk) and torch.equal(v, wv)
    _within(y, want, v)


@pytest.mark.cuda
def test_a_head_dim_without_an_instance_raises_on_the_card(cuda):
    cfg, p, x, pos = _attention("bfloat16", 48, cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        L.attention_apply(p, x, cfg, positions=pos)


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("what,shapes,kw,err,match", [
    ("head_dim", ((1, 8, 2, 48), (1, 8, 2, 48)), {}, ValueError, "head dim"),
    ("dtype", ((1, 8, 2, 80), (1, 8, 2, 80), torch.float32), {}, TypeError, "bfloat16"),
    ("groups", ((1, 8, 6, 80), (1, 8, 4, 80)), {}, ValueError, "multiple of KV"),
    ("offset", ((1, 8, 2, 80), (1, 8, 2, 80)), {"q_offset": -1}, ValueError, "q_offset"),
    ("device", ((1, 8, 2, 80), (1, 8, 2, 80)), {}, ValueError, "CUDA tensors"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what, shapes, kw, err, match):
    qs, ks, *dt = shapes
    dtype = dt[0] if dt else torch.bfloat16
    q, k = torch.zeros(qs, dtype=dtype), torch.zeros(ks, dtype=dtype)
    reset_launch_counts()
    with pytest.raises(err, match=match):
        attn.causal_attention(q, k, k.clone(), **kw)
    assert launch_counts()["causal_attention"] == 0


def test_attention_flops_at_zamba2s_prefill():
    """Causal Q K^T and P V at (8, 4,096, 32, 80): 687.4 GFLOP, 0.695 ms at
    989 TFLOP/s of bf16."""
    flops = attn.attention_flops(8, 4096, 32, 80)
    assert flops == 2 * 80 * 4096 * 4097 * 8 * 32 == 687_362_539_520
    assert abs(flops / 989e12 * 1e3 - 0.695) < 5e-4

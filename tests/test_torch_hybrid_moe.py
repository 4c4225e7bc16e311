"""The port's granite-4.0-h model (``HybridMoELM``, family ``hybrid_moe``)
against the benchmark's plain float32 reference
(``port_bench/reference/granite_hybrid.py``), at smoke size on the CPU.

``smoke(granite-4.0-h-small)``: float32, 4 layers of width 64 (Mamba-2,
attention, Mamba-2, Mamba-2), Mamba-2 with 8 heads of P=16 and N=16 in
chunks of 8, attention of 4 query heads over 2 K/V heads of 16 without
positional embedding at the preset's scale 1/128, and in every layer a
dropless MoE of 8 experts of width 128, 4 routed per token, beside a shared
expert of width 64; the preset's scalings (x12, x0.22, /16).  Weights are the
port's own seeded init, handed to the reference by leaf name.

Tolerances: 2e-4 of the largest magnitude (the Mamba tests' tolerance):
both sides compute in float32, but the port's SSD scan runs in chunks of 8
where the reference takes one chunk per divisor of T, its MoE sums the
routed slots in another order, and the residual stream grows by x12 at the
embedding, so the sums of a few hundred products differ by round-off of
about 1e-6 of their size.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import grow_cache
from repro_torch.models.config import smoke
from repro_torch.models.model import HybridMoELM, build_model, meta_model
from repro_torch.obs import spans

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.common import flat  # noqa: E402
from port_bench.reference import granite_hybrid as ref  # noqa: E402

TOL = 2e-4
CFG = smoke(get_config("granite-4.0-h-small"))


def _model(seed: int = 0):
    return build_model(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))


def _reference(model):
    """The reference's weights (the port's leaves by name) and shape."""
    return flat(model.tree()), ref.Shape.of(dataclasses.asdict(CFG))


def _close(got, want, what):
    want = want.float()
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=TOL * float(want.abs().max()), rtol=0, err_msg=what)


def _tokens(b: int, t: int, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG.vocab, (b, t)))


@pytest.mark.parametrize("t", [16, 12])  # 12: a ragged chunk for the port's SSD scan
def test_prefill_logits_and_every_cache_match_the_reference(t):
    model = _model()
    w, s = _reference(model)
    toks = _tokens(2, t)
    logits, cache = model.prefill(toks)
    assert logits.shape == (2, 1, CFG.vocab)
    assert set(cache) == {"conv", "ssd", "ak", "av", "len"} and cache["len"] == t
    for r in range(2):
        want, wcache = ref.last_logits(w, toks[r], s)
        _close(logits[r, 0], want, f"row {r} logits")
        for key in ("conv", "ssd", "ak", "av"):
            assert len(wcache[key]) == cache[key].shape[0], key
            for i, layer in enumerate(wcache[key]):
                _close(cache[key][i, r], layer, f"row {r} {key} {i}")


def test_prefill_then_decode_through_the_cache_matches_the_full_forward():
    """Prefill 10 tokens, grow the K/V caches as ``serve()`` does, decode 3:
    each step's logits against the reference's logits at that position of a
    full forward pass."""
    model = _model(2)
    w, s = _reference(model)
    toks = _tokens(2, 13, seed=3)
    logits, cache = model.prefill(toks[:, :10])
    grow_cache(cache, 3)
    full = [ref.all_logits(w, toks[r], s) for r in range(2)]
    for r in range(2):
        _close(logits[r, 0], full[r][9], f"row {r} prefill")
    for i in range(3):
        logits, cache = model.decode_step(cache, toks[:, 10 + i: 11 + i])
        assert cache["len"] == 11 + i
        for r in range(2):
            _close(logits[r, 0], full[r][10 + i], f"row {r} step {i}")


def test_the_pattern_sets_each_layers_mixer_and_stacks():
    cfg = get_config("granite-4.0-h-small")
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert (cfg.layers_of("mamba"), cfg.layers_of("attention")) == (36, 4)
    model = meta_model(cfg)
    assert isinstance(model, HybridMoELM) and model.n_apps == 4
    assert model.mamba.w_z.shape == (36, 4096, 8192)
    assert model.attn.wq.shape == (4, 4096, 4096) and model.attn.wk.shape == (4, 4096, 1024)
    assert model.layers.moe.w_gate.shape == (40, 72, 4096, 768)
    assert model.layers.moe.shared.w_in.shape == (40, 4096, 1536)
    assert not hasattr(model, "lm_head")  # tied
    kinds = [k for k, *_ in _model()._stacks()]
    assert kinds == list(CFG.layer_types) == ["mamba", "attention", "mamba", "mamba"]
    with pytest.raises(ValueError, match="layer_types"):
        smoke(cfg, n_layers=6)


def test_param_count_is_the_published_32_2b():
    cfg = get_config("granite-4.0-h-small")
    n = cfg.param_count()
    assert abs(n - 32.2e9) <= 0.001 * 32.2e9
    assert n == sum(p.numel() for p in meta_model(cfg).parameters()) == 32_207_337_984
    assert abs(cfg.active_param_count() - 8.8e9) < 0.05e9
    assert CFG.param_count() == sum(p.numel() for p in _model().parameters())


def test_init_cache_holds_both_kinds_of_state():
    model = _model()
    cache = model.init_cache(3, 7)
    assert cache["conv"].shape == (3, 3, CFG.ssm_conv - 1, CFG.d_inner + 2 * CFG.ssm_state)
    assert cache["ssd"].shape == (3, 3, CFG.ssm_nheads, CFG.ssm_state, CFG.ssm_head_dim)
    assert cache["ak"].shape == cache["av"].shape == (1, 3, 7, CFG.n_kv_heads, CFG.hd())
    _, cache = model.prefill(torch.zeros((3, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="full"):
        model.decode_step(cache, torch.zeros((3, 1), dtype=torch.long))


def test_prefill_opens_the_moe_spans_once_per_layer():
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill(_tokens(2, 16))
    names = [e.name for e in prof.events()]
    assert names.count(spans.MOE) == names.count(spans.MOE_EXPERTS) == CFG.n_layers
    assert names.count(spans.MAMBA) == 3 and names.count(spans.ATTENTION) == 1


def test_loss_is_the_cross_entropy_of_the_reference_logits():
    model = build_model(dataclasses.replace(CFG, remat=True), device="cpu",
                        generator=torch.Generator().manual_seed(4))
    w, s = _reference(model)
    toks = _tokens(2, 17, seed=5)
    params = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
    loss = torch.func.functional_call(model, params,
                                      ("loss", {"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    want = torch.stack([torch.nn.functional.cross_entropy(ref.all_logits(w, toks[r, :-1], s),
                                                          toks[r, 1:]) for r in range(2)]).mean()
    assert abs(float(loss.detach()) - float(want)) <= TOL * float(want)
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grouped_products_on_the_card_match_each_experts_product(dtype):
    """The dropless MoE's grouped products on the card, at granite's widths
    (4,096 and 768) with 72 experts of uneven counts, some empty, against
    each expert's own product on its segment: both sum in f32, and in bf16
    each rounds once, so they agree within one bf16 ulp (2^-7 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    counts = torch.randint(0, 400, (72,), generator=gen, device="cuda")
    counts[::7] = 0
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    src = torch.randn(int(ends[-1]), 4096, generator=gen, device="cuda").to(dt)
    w = (torch.randn(72, 4096, 768, generator=gen, device="cuda") * 4096 ** -0.5).to(dt)
    got = torch._grouped_mm(src, w, offs=ends)
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        want = src[lo:hi].float() @ w[e].float()
        err = (got[lo:hi].float() - want).abs()
        assert bool((err <= 2 ** -7 * want.abs() + 1e-3).all()), (e, float(err.max()))
        lo = hi

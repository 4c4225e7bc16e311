"""The port's ``TransformerLM`` (families dense, moe and vlm) against the JAX
package's, at smoke size.

The weights are the JAX ``init(PRNGKey(0))`` tree of each architecture's
``smoke()`` config (float32, 2 layers, d_model 64, 4 heads of 16), carried
into the port by ``repro_torch.models.convert``; tokens, vision prefixes and
activations are made with numpy from a seed.  Prefill logits and caches,
then three decode steps' logits and caches, must agree within 2e-4, the
Mamba tests' model tolerance (the two sum in other orders).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _port import assert_prefill_and_decode_match, model_pair
from repro_torch.configs import get_config
from repro_torch.launch.serve import grow_cache
from repro_torch.models import layers as L
from repro_torch.models.config import smoke
from repro_torch.models.convert import load_jax_params, param_names
from repro_torch.models.model import TransformerLM, build_model


@pytest.mark.parametrize("arch,overrides", [
    ("smollm-135m", {}),             # tied head with its d_model ** -0.5 scale
    ("qwen2.5-3b", {}),              # qkv bias, GQA
    ("deepseek-7b", {}),             # MHA
    ("grok-1-314b", {}),             # MoE top-2
    # MoE top-1 with a shared expert; a local-attention chunk short enough to act
    ("llama4-scout-17b-a16e", {"attn_chunk": 4}),
    ("paligemma-3b", {}),            # MQA, the projected vision prefix
], ids=lambda v: v if isinstance(v, str) else "")
def test_prefill_and_decode_match_reference(arch, overrides):
    model = assert_prefill_and_decode_match(arch, **overrides)
    assert isinstance(model, TransformerLM)


def test_convert_carries_every_leaf():
    """Every leaf of the reference's tree lands, bit for bit, in the port
    parameter of its path; the MoE router stays float32 in a bf16 model."""
    _, _, jparams, tmodel = model_pair("llama4-scout-17b-a16e")
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    params = param_names(tmodel)
    assert set(flat) == set(params)
    assert "layers/mlp/shared/w_gate" in params and "lm_head" in params
    for name, leaf in flat.items():
        assert np.array_equal(params[name].numpy(), leaf), name
    bf16 = build_model(dataclasses.replace(tmodel.cfg, dtype="bfloat16"), device="cpu")
    assert bf16.layers.mlp.router.dtype == torch.float32
    assert bf16.layers.mlp.w_in.dtype == torch.bfloat16


def test_convert_refuses_a_tree_of_another_shape():
    jcfg, _, jparams, tmodel = model_pair("smollm-135m")
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = np.zeros((jcfg.d_model, jcfg.vocab), np.float32)  # tied: no lm_head
    with pytest.raises(KeyError, match="lm_head"):
        load_jax_params(tmodel, tree)
    tree = jax.tree.map(np.asarray, jparams)
    tree["final_norm"] = np.ones((jcfg.d_model + 1,), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        load_jax_params(tmodel, tree)


def test_moe_runs_in_every_layer_whatever_moe_every():
    """The reference picks MoE in every layer whenever n_experts > 0 and
    ignores moe_every; the port copies that."""
    cfg = smoke(get_config("grok-1-314b"), moe_every=2)
    model = build_model(cfg, device="cpu")
    assert model.layers.mlp.router.shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "paligemma-3b"])
def test_decode_matches_a_longer_prefill(arch):
    """prefill(t) then decode steps give the last logits of prefill(t + i)
    (the vlm with its vision prefix on both sides)."""
    cfg = smoke(get_config(arch))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 15)))
    kw = {}
    if cfg.family == "vlm":
        kw["vis_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.vis_prefix_len, cfg.vis_embed_dim)).astype(np.float32))
    logits, cache = model.prefill(toks[:, :12], **kw)
    assert cache["len"] == 12 + (cfg.vis_prefix_len if kw else 0)
    grow_cache(cache, 3)
    for i in range(3):
        logits, cache = model.decode_step(cache, toks[:, 12 + i : 13 + i])
        want, _ = model.prefill(toks[:, : 13 + i], **kw)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_init_cache_has_the_reference_shapes_and_decode_refuses_a_full_cache():
    cfg = smoke(get_config("qwen2.5-3b"))
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(3, 5)
    assert cache["k"].shape == (cfg.n_layers, 3, 5, cfg.n_kv_heads, cfg.hd())
    assert cache["len"] == 0 and not cache["v"].any()
    _, cache = model.prefill(torch.zeros((2, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="full"):
        model.decode_step(cache, torch.zeros((2, 1), dtype=torch.long))


def test_vis_embeds_only_for_a_vlm_and_the_sharding_flags_raise():
    cfg = smoke(get_config("qwen2.5-3b"))
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="vis_embeds"):
        model.prefill(torch.zeros((1, 4), dtype=torch.long), vis_embeds=torch.zeros(1, 2, 8))
    # the sharding flags need a mesh to act; off one they change nothing
    tokens = torch.arange(8).reshape(2, 4)
    want, _ = model.prefill(tokens)
    for flag in ("attn_seq_shard", "fsdp_gather"):
        other = build_model(dataclasses.replace(cfg, **{flag: True}), device="cpu")
        got, _ = other.prefill(tokens)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert L.MASKED == -1e30


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b", "whisper-small"])
def test_every_family_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke(get_config(arch)))

"""The port's zamba2-style hybrid (``MambaLM`` of family ``hybrid``) against
the JAX package's, at smoke size.

``smoke(zamba2-2.7b)``: float32, 4 Mamba-2 layers (d_model 64, 8 heads of
P=16, N=16, chunk 8) and one shared attention + MLP block applied after
layers 1 and 3 (``shared_attn_every`` 2), with the JAX init carried across
by ``convert.py``.  Prefill logits and caches (``conv``, ``ssd``, ``ak``,
``av``), then three decode steps, must agree within 2e-4, the Mamba tests'
tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from _port import assert_prefill_and_decode_match, model_pair
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch.serve import grow_cache
from repro_torch.models.config import smoke
from repro_torch.models.convert import param_names
from repro_torch.models.model import MambaLM, build_model


@pytest.mark.parametrize("t", [12, 16])  # 12: a ragged chunk for the SSD scan
def test_prefill_and_decode_match_reference(t):
    model = assert_prefill_and_decode_match("zamba2-2.7b", t=t)
    assert isinstance(model, MambaLM) and model.hybrid


def test_shared_block_is_one_set_of_weights_applied_n_apps_times():
    cfg = get_config("zamba2-2.7b")
    assert cfg.n_layers // cfg.shared_attn_every == 9  # the full model's applications
    _, _, jparams, tmodel = model_pair("zamba2-2.7b")
    assert tmodel.n_apps == 2
    assert [i for i in range(4) if tmodel._is_app(i)] == [1, 3]
    params = param_names(tmodel)
    assert params["shared/attn/wq"].shape == (64, 4 * 16)  # not stacked over layers
    flat = {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert flat == set(params)
    _, cache = tmodel.prefill(torch.zeros((2, 5), dtype=torch.long))
    assert cache["ak"].shape == (2, 2, 5, 2, 16) == cache["av"].shape


def test_prefill_runs_the_scan_once_per_layer(monkeypatch):
    """Each Mamba-2 layer's prefill reaches the SSD scan once (its plain
    version on the CPU, where the card would launch the kernels)."""
    calls = []
    real = ref.ssd_scan_ref
    monkeypatch.setattr(ref, "ssd_scan_ref", lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = smoke(get_config("zamba2-2.7b"))
    model = build_model(cfg, device="cpu")
    model.prefill(torch.zeros((2, 16), dtype=torch.long))
    assert len(calls) == cfg.n_layers


def test_decode_matches_a_longer_prefill():
    cfg = smoke(get_config("zamba2-2.7b"))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 13)))
    logits, cache = model.prefill(toks[:, :10])
    grow_cache(cache, 3)
    for i in range(3):
        logits, cache = model.decode_step(cache, toks[:, 10 + i : 11 + i])
        want, _ = model.prefill(toks[:, : 11 + i])
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_init_cache_and_a_full_cache():
    cfg = smoke(get_config("zamba2-2.7b"))
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(3, 7)
    assert cache["ak"].shape == (2, 3, 7, cfg.n_kv_heads, cfg.hd())
    assert cache["ssd"].shape == (cfg.n_layers, 3, cfg.ssm_nheads, cfg.ssm_state,
                                  cfg.ssm_head_dim)
    assert cache["conv"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    _, cache = model.prefill(torch.zeros((3, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="full"):
        model.decode_step(cache, torch.zeros((3, 1), dtype=torch.long))

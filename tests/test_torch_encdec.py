"""The port's whisper-style ``EncDecLM`` against the JAX package's, at smoke
size.

``smoke(whisper-small)``: float32, 2 encoder and 2 decoder layers (d_model
64, 4 heads of 16), 8 stub frames, with the JAX init carried across by
``convert.py``; tokens and frame embeddings are made with numpy from a
seed.  Prefill logits and caches (``k``, ``v``, ``ck``, ``cv``), then three
decode steps, must agree within 2e-4, the Mamba tests' model tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port import assert_prefill_and_decode_match, model_pair, model_inputs
from repro_torch.configs import get_config
from repro_torch.launch.serve import grow_cache
from repro_torch.models.config import smoke
from repro_torch.models.model import EncDecLM, build_model


@pytest.mark.parametrize("t", [12, 5])
def test_prefill_and_decode_match_reference(t):
    model = assert_prefill_and_decode_match("whisper-small", t=t)
    assert isinstance(model, EncDecLM)


def test_encoder_and_cross_kv_match_reference():
    """The bidirectional encoder (rope on the frames, no mask) and the
    per-layer cross K/V, alone."""
    jcfg, jmodel, jparams, tmodel = model_pair("whisper-small")
    jin, tin = model_inputs(jcfg, np.random.default_rng(3), 2)
    jenc = jmodel._encode(jparams, jin["frames"])
    tenc = tmodel._encode(tin["frames"])
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=2e-5, rtol=2e-5)
    for got, want in zip(tmodel._cross_kv(tenc), jmodel._cross_kv(jparams, jenc)):
        assert tuple(got.shape) == want.shape == (2, 2, jcfg.enc_len, jcfg.n_kv_heads, jcfg.hd())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_encoder_is_bidirectional():
    """Changing the last frame changes the encoder output at the first."""
    cfg = smoke(get_config("whisper-small"))
    model = build_model(cfg, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, cfg.enc_len, cfg.d_model)).astype(np.float32))
    a = model._encode(frames)
    frames[:, -1] += 1.0
    assert not torch.allclose(model._encode(frames)[:, 0], a[:, 0])


def test_decode_matches_a_longer_prefill():
    cfg = smoke(get_config("whisper-small"))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)))
    _, kw = model_inputs(cfg, rng, 2)
    logits, cache = model.prefill(toks[:, :10], **kw)
    grow_cache(cache, 3)
    for i in range(3):
        logits, cache = model.decode_step(cache, toks[:, 10 + i : 11 + i])
        want, _ = model.prefill(toks[:, : 11 + i], **kw)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_prefill_needs_frames_in_both_packages():
    jcfg, jmodel, jparams, tmodel = model_pair("whisper-small")
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(KeyError, match="frames"):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    with pytest.raises(ValueError, match="frames"):
        tmodel.prefill(torch.from_numpy(toks))


def test_init_cache_has_the_reference_shapes():
    jcfg, jmodel, _, tmodel = model_pair("whisper-small")
    want = jmodel.init_cache(3, 9)
    got = tmodel.init_cache(3, 9)
    assert set(got) == set(want)
    for key in ("k", "v", "ck", "cv"):
        assert tuple(got[key].shape) == want[key].shape
    assert got["len"] == 0
    assert jax.tree.leaves(want)  # ShapeDtypeStructs in the reference

"""The port's Mamba-2 model against the JAX package's, at smoke size.

The weights are the JAX ``MambaLM.init(PRNGKey(0))`` tree of
``smoke(mamba2-1.3b)`` (float32, 2 layers, d_model 64, 4 heads of P=16,
N=16, chunk 8), carried into the port by ``repro_torch.models.convert``.
Token ids and activations are made with numpy from a seed.  Tolerance is
2e-4, the JAX suite's for model outputs against ``ssd_chunked``
(``tests/test_kernels.py``): the port scans sequentially on the CPU where the
reference scans by chunks, and matmuls sum in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba2 as jm
from repro.models.config import smoke as j_smoke
from repro.models.model import MambaLM as JMambaLM
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as tm
from repro_torch.models.config import ModelConfig, smoke
from repro_torch.models.convert import load_jax_params, param_names
from repro_torch.models.model import per_layer, build_model

TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(j_get_config("mamba2-1.3b"))
    jmodel = JMambaLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = load_jax_params(build_model(smoke(get_config("mamba2-1.3b")), device="cpu"), tree)
    return jcfg, jmodel, jparams, tree, tmodel


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _tokens(seed, vocab, b, t):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_configs_are_copied():
    """Every field of the reference's config has the reference's value; the
    fields the port adds (granite-4.0-h's layer pattern, scalings, NoPE,
    dropless routing) keep their defaults, which leave the model as it was."""
    defaults = _fields(ModelConfig(name="", family="", n_layers=0, d_model=0, n_heads=0,
                                   n_kv_heads=0, d_ff=0, vocab=0))
    for name in ("mamba2-1.3b", "zamba2-2.7b", "qwen2.5-3b"):
        for port, ref in ((get_config(name), j_get_config(name)),
                          (smoke(get_config(name)), j_smoke(j_get_config(name)))):
            got, want = _fields(port), _fields(ref)
            assert {k: got[k] for k in want} == want
            assert [k for k in got if k in want] == list(want)
            assert {k: got[k] for k in set(got) - set(want)} == \
                {k: defaults[k] for k in set(got) - set(want)}


def test_convert_carries_every_leaf(pair):
    _, _, _, tree, tmodel = pair
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    params = param_names(tmodel)
    assert set(flat) == set(params)
    for name, leaf in flat.items():
        assert np.array_equal(params[name].numpy(), leaf), name


@pytest.mark.parametrize("t", [12, 2])  # 12: ragged for chunk 8; 2: shorter than the conv tail
def test_mamba_apply_prefill_and_decode(pair, t):
    jcfg, _, jparams, _, tmodel = pair
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    xn = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda v: v[0], jparams["layers"]["block"])
    tp = per_layer(tmodel.layers.tree(), tmodel.cfg.n_layers)[0]["block"]
    jout, (jtail, jstate) = jm.mamba_apply(jp, jnp.asarray(x), jcfg)
    tout, (ttail, tstate) = tm.mamba_apply(tp, torch.from_numpy(x), tmodel.cfg)
    _close(tout, jout)
    _close(ttail, jtail)
    _close(tstate, jstate)
    jout, (jconv, jssd) = jm.mamba_apply(jp, jnp.asarray(xn), jcfg, state=(jtail, jstate))
    tout, (tconv, tssd) = tm.mamba_apply(tp, torch.from_numpy(xn), tmodel.cfg,
                                         state=(ttail, tstate))
    _close(tout, jout)
    _close(tconv, jconv)
    _close(tssd, jssd)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 6), (4, 6), (6,)))
    _close(tm.causal_conv(*map(torch.from_numpy, (x, w, b))),
           jm.causal_conv(*map(jnp.asarray, (x, w, b))), 1e-6)


def test_prefill_and_decode_match_reference(pair):
    """``prefill`` logits and cache (conv, ssd, len), then three decode
    steps' logits and cache, against the JAX model."""
    jcfg, jmodel, jparams, _, tmodel = pair
    toks = _tokens(1, jcfg.vocab, 2, 15)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :12], jnp.int32)})
    tlog, tcache = tmodel.prefill(torch.from_numpy(toks[:, :12]))
    assert tuple(tlog.shape) == (2, 1, jcfg.vocab)
    assert tcache["len"] == int(jcache["len"]) == 12
    for key in ("conv", "ssd"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
    _close(tlog, jlog)
    for i in range(12, 15):
        jlog, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        tlog, tcache = tmodel.decode_step(tcache, torch.from_numpy(toks[:, i:i + 1]))
        _close(tlog, jlog)
        for key in ("conv", "ssd"):
            _close(tcache[key], jcache[key])
        assert tcache["len"] == int(jcache["len"]) == i + 1


@pytest.mark.parametrize("t", [12, 16])
def test_decode_matches_prefill(pair, t):
    """prefill(t) then k decode steps gives the last logits of
    prefill(t + i) at every step i (t = 12 pads a ragged chunk)."""
    *_, tmodel = pair
    toks = torch.from_numpy(_tokens(7, tmodel.cfg.vocab, 2, t + 3))
    logits, cache = tmodel.prefill(toks[:, :t])
    for i in range(3):
        logits, cache = tmodel.decode_step(cache, toks[:, t + i : t + i + 1])
        want, _ = tmodel.prefill(toks[:, : t + i + 1])
        _close(logits, want.numpy())

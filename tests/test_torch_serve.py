"""The port's serving loop against the JAX package's, and its entry points.

The serve tests run ``repro_torch.launch.serve.serve`` and the reference's
loop (``repro/launch/serve.py``: batches taken from the queue, a short batch
padded with repeats, jitted prefill, the KV caches padded by ``gen_len``,
then decode) on the same smoke-size weights of each architecture (the JAX
init carried across by ``convert.py``).  Both are teacher-forced with the
same numpy-seeded tokens, so one numeric difference cannot change the path,
and the logits of every step must agree within 2e-4 (the JAX suite's model
tolerance against ``ssd_chunked``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS  # the architectures the JAX reference has
from repro.configs import get_config as j_get_config
from repro.models.config import smoke as j_smoke
from repro.models.model import MambaLM as JMambaLM
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.config import smoke
from repro_torch.models.convert import load_jax_params
from repro_torch.models.model import MambaLM, build_model

BATCH, PROMPT, GEN, REQUESTS = 2, 12, 4, 5


def _forced(seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (BATCH, 1)) for _ in range(64)]


def _jax_serve(model, params, queue, forced):
    """The reference's token loop (serve.py), teacher-forced; returns the
    logits of every step."""
    queue, seen, forced = list(queue), [], iter(forced)
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    while queue:
        prompts = [jnp.asarray(queue.pop(0), jnp.int32)
                   for _ in range(min(BATCH, len(queue)))]
        while len(prompts) < BATCH:
            prompts.append(prompts[-1])
        logits, cache = prefill(params, {"tokens": jnp.stack(prompts)})
        for k in ("k", "v", "ak", "av"):  # serve.py:110-115
            if k in cache:
                pad = [(0, 0)] * cache[k].ndim
                pad[2] = (0, GEN)
                cache[k] = jnp.pad(cache[k], pad)
        seen.append(np.asarray(logits))
        tok = jnp.asarray(next(forced), jnp.int32)
        for _ in range(GEN - 1):
            logits, cache = decode(params, cache, tok)
            seen.append(np.asarray(logits))
            tok = jnp.asarray(next(forced), jnp.int32)
    return seen


def _pair(arch):
    jcfg = j_smoke(j_get_config(arch))
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(build_model(smoke(get_config(arch)), device="cpu"),
                             jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, jcfg.vocab, (PROMPT,)) for _ in range(REQUESTS)]
    return jmodel, jparams, tmodel, queue, _forced(1, jcfg.vocab)


def _port_serve(tmodel, queue, forced):
    seen, it = [], iter(forced)

    def choose(logits):
        seen.append(logits.numpy().copy())
        return torch.from_numpy(next(it))

    return serve.serve(tmodel, queue, batch=BATCH, gen_len=GEN, choose=choose), seen


def test_serve_matches_reference_loop_teacher_forced():
    jmodel, jparams, tmodel, queue, forced = _pair("mamba2-1.3b")
    assert isinstance(jmodel, JMambaLM)
    want = _jax_serve(jmodel, jparams, queue, forced)
    st, seen = _port_serve(tmodel, queue, forced)
    assert len(seen) == len(want) == 3 * GEN
    for got, exp in zip(seen, want):
        np.testing.assert_allclose(got, exp, atol=2e-4, rtol=2e-4)
    assert (st.requests, st.prefill_calls) == (REQUESTS, 3)
    assert st.prefill_tokens == 3 * BATCH * PROMPT
    assert st.decode_tokens == 3 * BATCH * (GEN - 1)
    assert [o.shape for o in st.outputs] == [(GEN,)] * REQUESTS
    # the last request is row 0 of the last (padded) batch: its forced tokens
    assert np.array_equal(st.outputs[-1], np.concatenate(forced[2 * GEN : 3 * GEN], 1)[0])


def test_run_serves_at_smoke_size_on_the_cpu(capsys):
    st = serve.run(["--device", "cpu", "--requests", "3", "--batch", "2",
                    "--prompt-len", "9", "--gen-len", "3"])
    assert (st.requests, st.prefill_calls, st.decode_tokens) == (3, 2, 2 * 2 * 2)
    assert st.prefill_tok_s > 0 and st.decode_tok_s > 0
    assert "served 3 requests of qwen2.5-3b on cpu" in capsys.readouterr().out


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("mamba2-1.3b"))
    assert build_model.__defaults__[0] == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(["--requests", "1"])
    with pytest.raises(ValueError):
        build_model(cfg, device="meta")


def test_random_init_follows_the_generator():
    cfg = smoke(get_config("mamba2-1.3b"))
    a, b, c = (build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert torch.equal(a.lm_head, b.lm_head)
    assert torch.equal(a.layers.block.w_x, b.layers.block.w_x)
    assert not torch.equal(a.lm_head, c.lm_head)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "mamba2-1.3b"])
def test_serve_matches_reference_loop_for_every_family(arch):
    """Every other architecture through both loops, teacher-forced.  An
    encoder-decoder fails in both: its prefill needs frames."""
    jmodel, jparams, tmodel, queue, forced = _pair(arch)
    if tmodel.cfg.family == "encdec":
        with pytest.raises(KeyError, match="frames"):
            _jax_serve(jmodel, jparams, queue, forced)
        with pytest.raises(ValueError, match="cannot be served from tokens alone"):
            _port_serve(tmodel, queue, forced)
        return
    want = _jax_serve(jmodel, jparams, queue, forced)
    st, seen = _port_serve(tmodel, queue, forced)
    assert len(seen) == len(want) == 3 * GEN
    for got, exp in zip(seen, want):
        np.testing.assert_allclose(got, exp, atol=2e-4, rtol=2e-4)
    assert (st.requests, st.prefill_calls, st.decode_tokens) == (REQUESTS, 3, 3 * BATCH * (GEN - 1))

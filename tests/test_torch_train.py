"""The port's training path against the JAX package's, at smoke size (f32).

For every architecture of ``configs/``, the reference's ``init(PRNGKey(0))``
goes into the port (``convert.load_jax_params``) and both train on the
reference's batches (``data/pipeline.py``) for three steps in lockstep: at
each step both start from the reference's parameters and optimizer state
(carried over by ``convert.params_from_jax`` / ``load_jax_opt_state``), and

* the loss agrees to 1e-5 relative (observed ~2e-7: sums in another order);
* every gradient leaf agrees to 1e-4 of the leaf's largest value (backward
  sums in another order; the SSD scan's gradient is the sequential scan's,
  the reference's the chunked form's), or to 1e-7 of the largest value of
  all the gradients where that is more: a leaf whose gradient is zero in
  exact arithmetic holds rounding noise on both sides (llama4-scout's
  router: top-1 weights renormalise to exactly 1);
* the global gradient norm of the port's own gradients agrees to 1e-5;
* the port's AdamW applied to the *reference's* gradients gives the
  reference's parameters and state to 1e-6 of each leaf's largest value
  (``test_torch_adamw.py``'s tolerance).

The update is compared on equal gradients because Adam's step is sign-like
where |g| is far above eps but within rounding of zero: there an ulp of
difference in g moves a parameter by up to 2 lr.  Remat (per-layer
``torch.utils.checkpoint``) gives the same loss and gradients bit for bit.
``launch.train.run`` on the CPU, from the reference's init, returns the
reference's loss list -- failed lane, restart and repeated steps included,
with and without gradient compression (its residual checkpointed too) --
at the reference restart test's rtol 1e-5, atol 1e-6; and the port of
``tests/test_checkpoint.py::test_restart_determinism`` recomputes the same
losses after a restore through the port's ``CheckpointEngine``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port import model_pair
from repro.configs import ARCHS  # the architectures the JAX reference has
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.checkpoint import _tree
from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models.config import smoke
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as tsteps

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-7
UPDATE_TOL = 1e-6
OPT = dict(lr=1e-3, warmup_steps=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_leaves(got, want, tol, what, floor=0.0):
    """Each leaf within ``tol`` of its largest value, or within ``floor`` of
    the largest value of all the leaves where that is more."""
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = _tree.leaves(got)
    assert len(wl) == len(gl), what
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for _, w in wl)
    for (path, w), g in zip(wl, gl):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol,
                                   atol=max(tol * np.abs(w).max(), floor * top, 1e-30),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    jcfg, jmodel, jparams, tmodel = model_pair(arch)
    tcfg = tmodel.cfg
    jopt, topt = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jvg = jax.jit(jax.value_and_grad(jmodel.loss))
    jupd = jax.jit(functools.partial(jadamw.apply_updates, jopt))
    like = tsteps.params_of(tmodel)
    jp, jst = jparams, jsteps.init_opt_state(jmodel, jparams, jopt)
    for step in range(3):
        jb = jpipe.batch_for_step(jpipe.DataConfig(2, 8, jcfg.vocab), jcfg, step)
        tb = tpipe.batch_for_step(tpipe.DataConfig(2, 8, tcfg.vocab), tcfg, step, device="cpu")
        tp = convert.params_from_jax(like, _np(jp))
        tst = convert.load_jax_opt_state(tp, _np(jst))
        jl, jg = jvg(jp, jb)
        tl, tg = tsteps.value_and_grad(tmodel, tp, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
        _assert_leaves(tg, jg, GRAD_TOL, f"{arch} step {step} grad", GRAD_FLOOR)
        jnew, jst2, jm = jupd(jp, jg, jst)
        _, _, own = tadamw.apply_updates(topt, tp, tg, tst)
        np.testing.assert_allclose(float(own["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_TOL)
        tnew, tst2, tm = tadamw.apply_updates(
            topt, tp, convert.params_from_jax(tp, _np(jg)), tst)
        assert float(tm["lr"]) == float(jm["lr"])
        _assert_leaves(tnew, jnew, UPDATE_TOL, f"{arch} step {step} params")
        for key in ("master", "m", "v"):
            _assert_leaves(tst2[key], jst2[key], UPDATE_TOL, f"{arch} step {step} {key}")
        assert int(tst2["step"]) == int(jst2["step"]) == step + 1
        jp, jst = jnew, jst2
    # the port's train step is value_and_grad followed by apply_updates
    _, train_step = tsteps.make_train_step(tcfg, topt, device="cpu")
    tp = convert.params_from_jax(like, _np(jparams))
    tst = tsteps.init_opt_state(tmodel, tp, topt)
    new, st, m = train_step(tp, tst, tb)
    l2, g2 = tsteps.value_and_grad(tmodel, tp, tb)
    want = tadamw.apply_updates(topt, tp, g2, tst)
    assert float(m["loss"]) == float(l2) and float(m["grad_norm"]) == float(want[2]["grad_norm"])
    for g, w in zip(_tree.leaves(new), _tree.leaves(want[0])):
        assert torch.equal(g, w)
    # params actually changed, as tests/test_models.py asks of the reference
    assert any(not torch.equal(a, b) for a, b in zip(_tree.leaves(new), _tree.leaves(tp)))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-small", "paligemma-3b"])
def test_remat_changes_memory_only(arch):
    from repro_torch.models.model import build_model

    models = {r: build_model(smoke(get_config(arch), remat=r), device="cpu",
                             generator=torch.Generator().manual_seed(3)) for r in (False, True)}
    cfg = models[False].cfg
    batch = tpipe.batch_for_step(tpipe.DataConfig(2, 11, cfg.vocab), cfg, 1, device="cpu")
    params = tsteps.params_of(models[False])
    l0, g0 = tsteps.value_and_grad(models[False], params, batch)
    l1, g1 = tsteps.value_and_grad(models[True], params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(_tree.leaves(g0), _tree.leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_train_run_matches_reference(compression):
    argv = ["--steps", "7", "--global-batch", "4", "--seq-len", "16", "--ckpt-every", "3",
            "--fail-lane", "1", "--fail-at", "4", "--restart-at", "5",
            "--compression", compression]
    want = jtrain.run(argv)
    _, _, jparams, _ = model_pair("smollm-135m")
    rep = {}
    got = ttrain.run(argv + ["--device", "cpu"], init_params=_np(jparams), report=rep)
    assert len(got) == len(want) == 9  # steps 4 and 5 are taken twice
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[5:7] == got[3:5]  # the restart recomputes the same losses
    assert rep["engine"]["saves"] == 2 and rep["engine"]["degraded_reads"] > 0
    assert len(rep["step_s"]) == 9


def test_restart_determinism():
    """The port of ``tests/test_checkpoint.py::test_restart_determinism``:
    restore + recompute reproduces the original loss trajectory."""
    cfg = smoke(get_config("smollm-135m"))
    opt_cfg = tadamw.AdamWConfig(warmup_steps=2)
    model, train_step = tsteps.make_train_step(cfg, opt_cfg, device="cpu")
    params = tsteps.params_of(model)
    opt = tsteps.init_opt_state(model, params, opt_cfg)
    dc = tpipe.DataConfig(4, 16, cfg.vocab)
    eng = CheckpointEngine(CheckpointConfig(n_lanes=4, scheme="raid5", group_size=8,
                                            block_bytes=512, zone_cap_blocks=512, n_zones=24,
                                            device="cpu"), logical_blocks=1 << 13)
    losses = []
    for step in range(6):
        params, opt, m = train_step(params, opt, tpipe.batch_for_step(dc, cfg, step, "cpu"))
        losses.append(float(m["loss"]))
        if step == 2:
            eng.save(step, {"params": params, "opt": opt})
    restored = eng.restore(2, {"params": params, "opt": opt})
    p2, o2 = restored["params"], restored["opt"]
    relosses = []
    for step in range(3, 6):
        p2, o2, m = train_step(p2, o2, tpipe.batch_for_step(dc, cfg, step, "cpu"))
        relosses.append(float(m["loss"]))
    np.testing.assert_allclose(relosses, losses[3:], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b", "whisper-small"])
def test_prefill_and_decode_steps_run_the_model_on_given_params(arch):
    """``make_prefill_step`` / ``make_decode_step`` run the model on the
    parameter tree they are given, not on the module's own."""
    cfg = smoke(get_config(arch))
    model, prefill_step = tsteps.make_prefill_step(cfg, device="cpu")
    _, decode_step = tsteps.make_decode_step(cfg, device="cpu")
    other = tsteps.params_of(tsteps.make_train_step(
        cfg, tadamw.AdamWConfig(), device="cpu", generator=torch.Generator().manual_seed(9))[0])
    batch = tpipe.batch_for_step(tpipe.DataConfig(2, 6, cfg.vocab), cfg, 0, device="cpu")
    logits, cache = prefill_step(other, batch)
    donor = tsteps.make_train_step(cfg, tadamw.AdamWConfig(), device="cpu",
                                   generator=torch.Generator().manual_seed(9))[0]
    kw = {k: batch[k] for k in ("frames", "vis_embeds") if k in batch}
    want, want_cache = donor.prefill(batch["tokens"], **kw)
    assert torch.equal(logits, want)
    from repro_torch.launch.serve import grow_cache

    nxt = batch["tokens"][:, -1:]
    got, _ = decode_step(other, grow_cache(cache, 1), nxt)
    want2, _ = donor.decode_step(grow_cache(want_cache, 1), nxt)
    assert torch.equal(got, want2)
    own, _ = model.prefill(batch["tokens"], **kw)
    assert not torch.equal(own, logits)

"""The port's data pipeline against the JAX package's.

``batch_for_step`` draws with jax.random (threefry2x32, partitionable mode)
in the reference and with the port's numpy copy of it: ``tokens`` and
``labels`` must be equal bit for bit; the stub ``frames`` and
``vis_embeds`` are sqrt(2) erfinv(u) of equal uniform values, with torch's
erfinv against XLA's, within 1e-6 (absolute; the values are ~0.02 N(0, 1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models.config import smoke as j_smoke
from repro_torch.configs import get_config
from repro_torch.data import _threefry as tf
from repro_torch.data import pipeline as tpipe
from repro_torch.models.config import smoke

STUB_TOL = 1e-6


@pytest.mark.parametrize("arch,seed,step,batch,seq", [
    ("smollm-135m", 0, 0, 8, 64),
    ("smollm-135m", 0, 7, 4, 16),
    ("mamba2-1.3b", 3, 12, 2, 33),
    ("qwen2.5-3b", 12345, 2**20 + 3, 3, 5),
    ("whisper-small", 1, 4, 2, 12),
    ("paligemma-3b", 2, 9, 3, 7),
])
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_batch_for_step_matches_reference(arch, seed, step, batch, seq, full):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if not full:
        jcfg, tcfg = j_smoke(jcfg), smoke(tcfg)
    want = jpipe.batch_for_step(jpipe.DataConfig(batch, seq, jcfg.vocab, seed), jcfg, step)
    got = tpipe.batch_for_step(tpipe.DataConfig(batch, seq, tcfg.vocab, seed), tcfg, step,
                               device="cpu")
    assert set(got) == set(want)
    for key in ("tokens", "labels"):
        assert got[key].dtype == getattr(__import__("torch"), "int32")
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in set(want) - {"tokens", "labels"}:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=STUB_TOL)


@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (7, 2**31 + 5), (2**32 - 1, 99)])
def test_key_functions_match_jax(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = tf.fold_in(tf.prng_key(seed), data)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_array_equal(tf.split(tk, 5), np.asarray(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(tf.random_bits(tk, (3, 7)),
                                  np.asarray(jax.random.bits(jk, (3, 7), jnp.uint32)))
    for lo, hi in ((0, 1), (0, 256), (-5, 50_000), (3, 2**31 - 1)):
        np.testing.assert_array_equal(
            tf.randint(tk, (4, 9), lo, hi),
            np.asarray(jax.random.randint(jk, (4, 9), lo, hi, jnp.int32)))
    np.testing.assert_array_equal(
        tf.uniform(tk, (5, 6), -1.0, 1.0),
        np.asarray(jax.random.uniform(jk, (5, 6), jnp.float32, -1.0, 1.0)))


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_shard_matches_reference(n_hosts):
    jcfg, tcfg = j_smoke(j_get_config("whisper-small")), smoke(get_config("whisper-small"))
    want = jpipe.batch_for_step(jpipe.DataConfig(8, 6, jcfg.vocab), jcfg, 3)
    got = tpipe.batch_for_step(tpipe.DataConfig(8, 6, tcfg.vocab), tcfg, 3, device="cpu")
    for host in range(n_hosts):
        w, g = jpipe.host_shard(want, host, n_hosts), tpipe.host_shard(got, host, n_hosts)
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))
        np.testing.assert_allclose(g["frames"].numpy(), np.asarray(w["frames"]), atol=STUB_TOL)

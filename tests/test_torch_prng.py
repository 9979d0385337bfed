"""tpulab_torch's threefry port vs ``jax.random`` (jax 0.9.0, partitionable
threefry).  Keys and uniform draws must be bit-equal; gumbel values are
``-log(-log(u))`` of those bits, so they agree to float32 rounding of
the two libraries' ``log`` (rtol 1e-6).  The sampled tokens must be the
same as tpulab's ``_device_sample_token`` for every case here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine.paged import _device_sample_token
from tpulab_torch.engine import prng

torch.set_num_threads(2)

_CASES = [((0, 0), 0), ((5, 7), 3), ((0xDEADBEEF, 0x12345678), 1499),
          ((2**32 - 1, 1), 65535)]


def _jax_key(seed2, pos):
    k = jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(seed2[0]))
    k = jax.random.fold_in(k, np.uint32(seed2[1]))
    return jax.random.fold_in(k, pos)


def _torch_key(seed2, pos):
    k = prng.prng_key(0, shape=(1,))
    k = prng.fold_in(k, torch.tensor([seed2[0]]))
    k = prng.fold_in(k, torch.tensor([seed2[1]]))
    return prng.fold_in(k, torch.tensor([pos]))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key_bits(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    hi, lo = prng.prng_key(seed, shape=())
    assert [int(hi), int(lo)] == [int(w) for w in want]


@pytest.mark.parametrize("seed2,pos", _CASES)
def test_fold_in_and_uniform_bits(seed2, pos):
    kj = _jax_key(seed2, pos)
    kt = _torch_key(seed2, pos)
    assert [int(w) for w in np.asarray(jax.random.key_data(kj))] == \
        [int(kt[0][0]), int(kt[1][0])]
    n = 1001   # odd: exercises the counter layout past any pairing
    tiny = jnp.finfo(jnp.float32).tiny
    uj = np.asarray(jax.random.uniform(kj, (n,), jnp.float32,
                                       minval=tiny, maxval=1.0))
    ut = prng.uniform(kt, n)[0].numpy()
    assert np.array_equal(uj.view(np.uint32), ut.view(np.uint32))
    gj = np.asarray(jax.random.gumbel(kj, (n,), jnp.float32))
    gt = prng.gumbel(kt, n)[0].numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)


def test_device_sample_tokens_match_tpulab():
    """Several (seed words, position, temperature) lanes in one batch;
    temperature 0 means argmax."""
    rng = np.random.default_rng(0)
    vocab = 257
    logits = (rng.standard_normal((len(_CASES) * 2, vocab)) * 2
              ).astype(np.float32)
    seeds = np.array([c[0] for c in _CASES] * 2, np.uint32)
    pos = np.array([c[1] for c in _CASES] * 2, np.int32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.0, 2.0, 0.9], np.float32)
    want = np.asarray(jax.vmap(_device_sample_token)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(seeds),
        jnp.asarray(pos)))
    got = prng.device_sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(pos))
    assert got.tolist() == want.tolist()
    assert got[0] == int(logits[0].argmax()) and got[5] == int(
        logits[5].argmax())

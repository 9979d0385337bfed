"""``jax.random``'s threefry2x32 stream, bit for bit, in PyTorch.

tpulab samples on the device with a Gumbel-max draw keyed by
``fold_in(fold_in(fold_in(PRNGKey(0), seed_lo), seed_hi), position)``
(``tpulab/engine/paged.py:538``).  One request must be one stream on
either backend, so the port reproduces jax 0.9.0's bits: threefry2x32
with 20 rounds, ``fold_in(key, d) = threefry2x32(key, (0, d))``, and the
*partitionable* counter layout (``jax_threefry_partitionable`` is True
there): element i of a 1-D draw hashes the 64-bit counter ``(0, i)`` and
keeps ``y0 ^ y1``.  ``uniform`` keeps the top 23 bits as a mantissa in
[1, 2), subtracts 1, scales to ``[tiny, 1)``; ``gumbel`` is
``-log(-log(u))``.

PyTorch's uint32 supports few ops, so words live in int64 tensors masked
to 32 bits.  A key is a pair of such tensors of any (broadcast) shape,
which batches the per-lane keys of a decode step.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) over int64 tensors holding uint32 words;
    returns ``(y0, y1)`` broadcast over the inputs."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None, shape=()):
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**64: the words
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    hi = torch.full(shape, (seed >> 32) & _M32, dtype=torch.int64,
                    device=device)
    lo = torch.full(shape, seed & _M32, dtype=torch.int64, device=device)
    return hi, lo


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` (int tensor, uint32 values)
    broadcast against the key's words."""
    k0, k1 = key
    data = data.to(torch.int64) & _M32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(key, n: int):
    """32-bit draws of a length-``n`` 1-D array per key: shape
    ``key.shape + (n,)``."""
    k0, k1 = key
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key, n: int):
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``."""
    bits = random_bits(key, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=floats.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=floats.device) - tiny
    return torch.maximum(tiny, floats * span + tiny)


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, n)))


def device_sample_tokens(logits, temps, seeds, positions):
    """Batched ``_device_sample_token``: Gumbel-max temperature sampling
    per lane, keyed by (seed words, position); ``temps == 0`` takes the
    argmax.

    logits (B, V) f32; temps (B,) f32; seeds (B, 2) int (lo, hi uint32
    words); positions (B,) int.  Returns (B,) int64 token ids."""
    seeds = seeds.to(torch.int64)
    key = prng_key(0, logits.device, (logits.shape[0],))
    key = fold_in(key, seeds[:, 0])
    key = fold_in(key, seeds[:, 1])
    key = fold_in(key, positions)
    g = gumbel(key, logits.shape[-1])
    pos_t = temps > 0
    safe_t = torch.where(pos_t, temps, torch.ones_like(temps))
    sampled = torch.argmax(logits / safe_t[:, None] + g, dim=-1)
    return torch.where(pos_t, sampled, torch.argmax(logits, dim=-1))

"""JAX's threefry-2x32 key rule in torch integer ops.

The serving engine's seeded sampling rule keys every step with
``fold_in(PRNGKey(seed), position)`` and draws with
``categorical(key, logits)`` (``tensorframes_tpu/serve/engine.py``,
``_prefill_impl`` and ``_decode_impl``). To emit the same seeded streams
as the JAX engine token for token, the port reproduces the bits exactly:

- ``PRNGKey(seed)``: the key is ``(seed >> 32, seed & 0xFFFFFFFF)``; a
  32-bit seed gives ``(0, uint32(seed))``;
- ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``;
- random bits for a shape, on the ``jax_threefry_partitionable`` path
  (on by default in current jax): the flat index ``i`` of every element
  as a 64-bit counter split into ``(hi, lo)`` words, hashed, and the two
  output words xor-ed;
- ``uniform(tiny, 1)`` from the top 23 bits as a float32 mantissa,
  ``gumbel = -log(-log(u))``, ``categorical = argmax(gumbel + logits)``.

uint32 arithmetic runs in int64 tensors masked to 32 bits. Every
function is batched over a leading key axis (``keys`` is ``[N, 2]``).
"""

from __future__ import annotations

import torch

__all__ = [
    "prng_key",
    "fold_in",
    "threefry2x32",
    "random_bits",
    "uniform",
    "gumbel",
    "categorical",
]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), as JAX's unrolled
    lowering writes it. All arguments are int64 tensors holding uint32
    values, broadcast together; returns the two output words."""
    k1 = k1 & _MASK
    k2 = k2 & _MASK
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seeds: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` for a batch of int32 seeds -> ``[N, 2]``."""
    s = seeds.to(torch.int64).reshape(-1)
    # an int32 seed: the high word is 0 and the low word is the seed's
    # bits read as uint32
    return torch.stack([torch.zeros_like(s), s & _MASK], dim=-1)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row-wise: ``[N, 2]`` keys, ``[N]`` ints."""
    d = data.to(torch.int64).reshape(-1) & _MASK
    # threefry_2x32(key, threefry_seed(d)): counts [0, d] split into the
    # two one-element halves x1 = [0], x2 = [d]
    o1, o2 = threefry2x32(
        keys[:, 0], keys[:, 1], torch.zeros_like(d), d
    )
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for a flat ``[n]`` draw per key (the
    partitionable path) -> ``[N, n]`` int64 holding uint32 values."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi = (idx >> 32)[None, :]
    lo = (idx & _MASK)[None, :]
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi, lo)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` per key."""
    bits = random_bits(keys, n)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (the default low-range mode) per key."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_F32_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)(keys, logits)``: one draw per row of
    ``[N, V]`` float32 logits with its own key -> ``[N]`` int64."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)

"""Counter-based random numbers for the sampler: JAX's threefry2x32 PRNG in
PyTorch (counterpart of what ``repro.models.model.sample_tokens`` draws
through ``jax.random``).

Reproduces, bit for bit, JAX 0.9's raw uint32 keys with
``jax_threefry_partitionable=True``:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)`` for a uint32 seed: the
  key ``(seed >> 32, seed & 0xFFFFFFFF) = (0, seed)``;
* :func:`fold_in` is ``threefry2x32(key, (0, data))``, both output words;
* :func:`random_bits` is 32-bit ``random_bits(key, (V,))``: the counts are
  the 64-bit iota split into ``(hi, lo) = (0, i)``, the result the XOR of
  the two output words;
* :func:`uniform` keeps the top 23 bits as a mantissa under exponent 0
  (``(bits >> 9) | 0x3F800000`` as f32, minus 1), then ``* (max - min) +
  min`` and ``max(min, .)``;
* :func:`gumbel` is mode "low": ``-log(-log(uniform(tiny, 1)))``;
* :func:`categorical` is ``argmax(gumbel + logits)``, first maximum.

torch has no full uint32 arithmetic, so words live in int64 tensors masked
to 32 bits. Keys are ``(..., 2)`` int64 tensors. Everything runs on the
device of its inputs. The integer steps and the uniforms are exact; ``log``
is PyTorch's, which may differ from XLA's by an f32 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: finfo(float32).tiny, the smallest normal f32: gumbel's lower bound
TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds, on int64 tensors holding
    uint32 words (broadcast against each other): key ``(k1, k2)``, counter
    ``(x1, x2)``. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed) -> torch.Tensor:
    """``PRNGKey(seed)`` for uint32 seeds: int64 (..., 2) keys ``(0, seed)``."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _M32
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for (..., 2) keys and uint32 data
    broadcast against the keys' leading shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits(key, (n,))`` for each of the (..., 2) keys:
    int64 (..., n) holding uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(lo), lo)
    return a ^ b


def uniform(key: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    of the (..., 2) keys: f32 (..., n)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # f32 bounds as host scalars (exact in f32): a bound made on the card
    # from a Python number would be an upload that waits for it
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))``, mode "low": f32 (..., n)."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    per row: the Gumbel-max draw, int64 (...)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)

"""The reference's counter-based PRNG, `jax.random` with its default
threefry implementation (`jax_threefry_partitionable`), as integer tensor
ops on any device, so a fixed seed gives the reference's bits on the CPU
and on the card alike.

A key is the pair (k0, k1) of 32-bit words; a batch of keys is a (..., 2)
tensor.  The words live in int64 lanes masked with 0xFFFFFFFF after every
add and shift (torch's uint32 has gaps on CUDA).  Nothing here reads a
value back to the host, so every function can run inside a CUDA graph.

  threefry2x32(key, (hi, lo))  the Threefry-2x32 block cipher, 20 rounds;
  PRNGKey(seed)                [0, seed];
  split(key, n)[i]             threefry2x32(key, (0, i));
  fold_in(key, d)              threefry2x32(key, (0, d));
  bits(key, n)[i]              x0 ^ x1 of threefry2x32(key, (0, i));
  uniform, gumbel              jax.random's float transforms of `bits`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counters (x0, x1) under `key` (..., 2); the
    counters broadcast against the key's batch shape.  Returns the two
    output words, int64 in [0, 2^32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int,
            device: Optional[Union[str, torch.device]] = None
            ) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: (2,) int64 [0, seed
    mod 2^32].  Built by a fill with the seed, so on the card it copies
    nothing from the host (`key[1] = x` would copy x and wait for the
    stream)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    key = torch.zeros((2,), dtype=torch.int64, device=device)
    key[1:].fill_(seed & MASK)
    return key


def _counters(key: torch.Tensor, n: int) -> torch.Tensor:
    """The counters 0 .. n-1 as a (1,)*batch + (n,) tensor."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return lo.reshape((1,) * (key.dim() - 1) + (n,))


def _keyed(key: torch.Tensor) -> torch.Tensor:
    """A (..., 2) key with a unit axis for the counters: (..., 1, 2)."""
    return key.unsqueeze(-2)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split` of each key: (..., 2) -> (..., n, 2)."""
    x0, x1 = threefry2x32(_keyed(key), torch.zeros_like(_counters(key, n)),
                          _counters(key, n))
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for 32-bit data: (..., 2) ->
    (..., 2); `data` is an int or a tensor broadcasting against the keys'
    batch shape."""
    if not isinstance(data, torch.Tensor):
        data = torch.full(key.shape[:-1], data & MASK, dtype=torch.int64,
                          device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(data), data.long() & MASK)
    return torch.stack([x0, x1], dim=-1)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` of each key: (..., 2) ->
    (..., n) int64 in [0, 2^32)."""
    x0, x1 = threefry2x32(_keyed(key), torch.zeros_like(_counters(key, n)),
                          _counters(key, n))
    return x0 ^ x1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32, minval, maxval)` of each
    key: the top 23 bits as the mantissa of a float in [1, 2), less one,
    then `floats * (maxval - minval) + minval` with one rounding, as XLA
    contracts it into a fused multiply-add (the f64 product of two f32
    values is exact), floored at minval.  (..., 2) -> (..., n) f32."""
    mant = (bits(key, n) >> 9) | _F32_ONE_BITS
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference in f32, as jax takes them, formed on
    # the host: a tensor made on the card here would be a copy from the
    # host, which a CUDA graph cannot capture
    lo = torch.tensor(minval, dtype=torch.float32)
    scale = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    out = (floats.double() * scale + float(lo)).float()
    return torch.clamp(out, min=float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` (its default mode, "low")
    of each key: -log(-log(u)), u uniform in [tiny, 1).  (..., 2) ->
    (..., n) f32."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0)))

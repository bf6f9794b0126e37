"""Bit-exact torch counterpart of the ``jax.random`` calls on the main path.

Keys are ``int64`` tensors of shape ``(..., 2)`` holding the two uint32
words of a raw threefry2x32 key, so a stack of lane keys is one tensor and
every function here broadcasts over the leading dims.  The generator is
JAX's ``threefry2x32`` with ``jax_threefry_partitionable=True`` (the JAX
default since 0.5): ``split``, ``fold_in`` and the random bits behind
``uniform``/``bernoulli``/``randint`` all hash a ``(hi, lo)`` counter pair
with the key, and 32-bit draws are ``bits1 ^ bits2``.

All arithmetic runs on ``int64`` masked to 32 bits: PyTorch has no ``>>``
on ``uint32`` on every device, and an ``int64`` holds a uint32 word
exactly.  ``gumbel`` and ``categorical`` (serving's sampling) take two
``log``s of the draw, which torch and XLA may round an ulp apart.
``normal`` is deliberately absent: initial parameters come across
from JAX (``repro_torch.convert``) or from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax name)
    """``jax.random.PRNGKey(seed)``: the key ``[seed >> 32, seed & mask]``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must be a non-negative 63-bit int: {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _split_words(key: torch.Tensor):
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"a key is an int64 (..., 2) tensor, got "
                         f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _hash_counters(key: torch.Tensor, shape: Sequence[int]):
    """threefry over the flat counter ``iota(prod(shape))`` of ``shape``,
    broadcast over the key's leading dims: out ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _split_words(key)
    tail = (1,) * len(shape)
    k1 = k1.reshape(k1.shape + tail)
    k2 = k2.reshape(k2.shape + tail)
    n = 1
    for s in shape:
        n *= s
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    counts = counts.reshape(shape)
    return threefry2x32(k1, k2, counts >> 32, counts & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    b1, b2 = _hash_counters(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` (an int, or an integer
    tensor broadcastable against ``key.shape[:-1]``) is taken mod 2^32."""
    k1, k2 = _split_words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _MASK
    else:
        # a fill on the key's device: no host copy
        d = torch.full((), int(data) & _MASK, dtype=torch.int64,
                       device=key.device)
    zero = torch.zeros_like(d)
    b1, b2 = threefry2x32(k1, k2, zero, d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 uniform random bits per element (``bits1 ^ bits2``), as int64."""
    b1, b2 = _hash_counters(key, shape)
    return b1 ^ b2


# (bits drawn, mantissa bits, the bits of 1.0, the int view) per type: JAX
# draws at least 8 bits, so bfloat16 (7 mantissa bits) takes 8, not 16
_FLOAT_DRAWS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
                torch.bfloat16: (8, 7, 0x3F80, torch.int16),
                torch.float16: (16, 10, 0x3C00, torch.int16)}


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.,
            maxval: float = 1.) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, for
    float32, bfloat16 and float16.

    A draw of fewer bits (16 for float16, 8 for bfloat16) is the low bits
    of ``bits1 ^ bits2``; the mantissa is its top ``nmant`` bits under the
    exponent of 1.0, and 1.0 is subtracted in ``dtype`` (exactly).  Another
    range than [0, 1) is JAX's ``max(minval, u * (maxval - minval) +
    minval)`` with XLA's rounding: each bfloat16 operation rounded, and for
    float32 and float16 the product and the sum contracted into one fused
    multiply-add, rounded once."""
    if dtype not in _FLOAT_DRAWS:
        raise ValueError(f"uniform draws {tuple(_FLOAT_DRAWS)}, got {dtype}")
    rng_bits, nmant, one, view = _FLOAT_DRAWS[dtype]
    bits = random_bits(key, shape) & ((1 << rng_bits) - 1)
    floats = ((bits >> (rng_bits - nmant)) | one).to(view).view(dtype)
    u = floats - torch.ones((), dtype=dtype, device=floats.device)
    if (minval, maxval) == (0., 1.):
        return u                        # JAX's scale and clamp change nothing
    lo = torch.as_tensor(minval, dtype=dtype, device=u.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=u.device)
    if dtype == torch.bfloat16:
        out = u * (hi - lo) + lo
    else:
        # the float64 product of two such floats is exact, so one rounding
        # of the float64 sum is the fused multiply-add's
        out = (u.double() * (hi - lo).double() + lo.double()).to(dtype)
    return torch.maximum(lo, out)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in JAX's default
    ``mode="low"``: ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny,
                maxval=1.)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max draw,
    ``argmax(gumbel + logits)`` (the first maximum, int64)."""
    g = gumbel(key, logits.shape, logits.dtype)
    return torch.argmax(g + logits, dim=axis)


def bernoulli(key: torch.Tensor, p: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p``, drawn and
    compared in ``p``'s float type.

    ``p`` broadcasts against ``key.shape[:-1] + shape`` (a lane stack of
    keys with ``(L, 1, ...)`` probabilities, say)."""
    return uniform(key, shape, p.dtype) < p


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 draws).

    JAX draws twice through ``split`` and folds the high word in by the
    multiplier ``2^32 mod span`` so that large spans stay near-uniform."""
    for v in (minval, maxval):
        if not -(1 << 31) <= int(v) < 1 << 31:
            raise ValueError(f"randint bounds must be int32, got {v}")
    minval, maxval = int(minval), int(maxval)
    span = max(maxval - minval, 1)       # JAX returns minval when max <= min
    k1, k2 = split(key).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    # JAX's uint32 arithmetic wraps: mask every product and sum to 32 bits
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)

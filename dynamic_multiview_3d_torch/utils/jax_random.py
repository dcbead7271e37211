"""The draws of ``jax.random`` (threefry2x32, ``jax_threefry_partitionable``
on), bitwise, with no JAX: what the port needs to draw the examples and
target subsets the JAX package's train step draws.

Layout (``jax/_src/prng.py``, ``jax/_src/random.py``):

- ``key(seed)``: the pair (seed >> 32, seed & 0xFFFFFFFF);
- ``threefry2x32(k, (x0, x1))``: 20 rounds, rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA);
- ``fold_in(k, d)``: ``threefry2x32(k, (0, d))``;
- ``split(k, n)[i]``: ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
- ``random_bits(k, shape)`` at 32 bits: ``y0 ^ y1`` of
  ``threefry2x32(k, (hi, lo))`` over the flat indices of ``shape``;
- ``randint``: a split, two bit draws, reduced by a uint32 span and a
  multiplier in uint32 arithmetic that wraps;
- ``permutation(k, n)``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a
  split, 32-bit sort keys and a stable sort.

Two faces. Keys that depend only on Python ints (the data seed and the
step) are pairs of Python ints: ``key``, ``fold_in`` and ``split`` on them
cost no tensor op, and such a key enters device work as two scalars (no
host-to-device copy). Per-example work takes keys whose halves are int64
tensors of any batch shape on any device: every value is kept in
[0, 2**32) and every op stays below 2**63 (a rotation shifts by at most
29; the one product of two 32-bit values, in ``randint``, goes by 16-bit
halves), so the CPU and CUDA give the same bits. ``threefry2x32`` is one
function for both faces.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def step_keys(seed: int, step: int, device_sampling: bool) -> tuple:
    """The keys of the JAX package's train step (``train/step.py``
    ``_one_step``) for optimizer step ``step``: ``key = fold_in(key(seed),
    step)``, and with device sampling ``key, k_samp = split(key)``. ->
    (the target subsampling's key, the device draw's key or None), pairs
    of Python ints."""
    k = fold_in(key(seed), step)
    if not device_sampling:
        return k, None
    return tuple(split(k))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counters (x0, x1) under the key (k0, k1):
    Python ints or int64 tensors (broadcast) holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s data for a seed JAX takes as a 32-bit
    integer (with x64 off): (0, seed mod 2**32)."""
    if not INT32_MIN <= seed <= M32:
        raise ValueError(f"a jax.random seed is a 32-bit integer: {seed}")
    return 0, seed & M32


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: ``data`` an int or an int64 tensor
    of example indices (taken mod 2**32, as JAX's uint32 cast); a tensor
    gives a key of its shape."""
    return threefry2x32(k[0], k[1], 0, data & M32)


def split(k, num: int = 2) -> list:
    """``jax.random.split(k, num)`` as a list of ``num`` keys. A key of
    tensors gives keys of its shape, from one threefry call."""
    if isinstance(k[0], int):
        return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]
    i = torch.arange(num, device=k[0].device)
    y0, y1 = threefry2x32(k[0][..., None], k[1][..., None], 0, i)
    return [(y0[..., i], y1[..., i]) for i in range(num)]


def _tensor_key(k) -> tuple:
    if isinstance(k[0], int):
        return tuple(torch.tensor(x, dtype=torch.int64) for x in k)
    return k


def random_bits(k, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values, for a key of
    batch shape S: a tensor [*S, *shape]."""
    k0, k1 = _tensor_key(k)
    n = math.prod(shape)
    i = torch.arange(n, device=k0.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], i >> 32, i & M32)
    return (y0 ^ y1).reshape((*k0.shape, *shape))


def mul32(x, c):
    """(x * c) mod 2**32 for x, c in [0, 2**32) (ints or int64 tensors):
    by the 16-bit halves of c, so no product passes 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def span(minval: int, maxval: int) -> int:
    """``randint``'s uint32 span over [minval, maxval): 1 where maxval <=
    minval (JAX then returns minval)."""
    if not (INT32_MIN <= minval <= INT32_MAX
            and INT32_MIN <= maxval <= INT32_MAX):
        raise ValueError(f"randint's bounds are int32 values: {minval}, "
                         f"{maxval}")
    return (maxval - minval) & M32 if maxval > minval else 1


def randint(k, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) as int64
    values, for a key of batch shape S: [*S, *shape]."""
    n = span(minval, maxval)
    k1, k2 = split(_tensor_key(k))
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    mult = (2 ** 16 % n) ** 2 % 2 ** 32 % n          # uint32 product wraps
    offset = ((mul32(hi % n, mult) + lo % n) & M32) % n
    return (minval + offset + 2 ** 31) % 2 ** 32 - 2 ** 31


def shuffle_rounds(n: int) -> int:
    """The sort rounds of ``jax.random.permutation`` of n elements."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(M32)))


def permutation(k, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` as int64 values, for a key of
    batch shape S: [*S, n]; the stable sort is ``torch.sort(stable=True)``
    on the 32-bit keys."""
    k = _tensor_key(k)
    x = torch.arange(n, device=k[0].device).expand((*k[0].shape, n))
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = x.gather(-1, order)
    return x

"""A replica of jax 0.9.0's threefry2x32 random numbers in torch integer ops.

The reference draws its bag masks, GOSS samples and per-node feature
samples with ``jax.random`` (``models/gbdt.py:273, 607-628``,
``models/goss.py:44``, ``ops/grow_depthwise.py:363``, ``ops/grow.py:230``)
under jax's default ``jax_threefry_partitionable = True``. This module
gives the same bits on any torch device:

- ``prng_key(seed)``: ``jax.random.PRNGKey`` in jax's default 32-bit mode,
  the key ``(0, seed mod 2**32)`` (``jax/_src/prng.py:802-830``);
- ``split(key, num)``: the partitionable "fold-like" split, threefry of
  the key over the counters ``(0, i)`` of an iota (``prng.py:1156``);
- ``fold_in(key, data)``: threefry of the key over the one counter pair
  ``(0, data)`` (``prng.py:1163-1170``);
- ``uniform(key, shape, minval, maxval)``: f32 uniforms from the 32-bit
  bits ``bits1 ^ bits2`` of threefry over the row-major iota counters of
  ``shape`` (``prng.py:1184-1200``), with ``jax.random._uniform``'s float
  construction (``jax/_src/random.py:435``): the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled and shifted with one
  rounding (XLA fuses the multiply and add), and at least ``minval``.

A key is a pair of Python ints (k1, k2). Keys derive from host integers
only (seeds, draw counts, tree and level numbers), so ``prng_key``,
``split`` and ``fold_in`` run the hash on Python ints on the host and never
touch the device; only ``uniform`` draws on a device,
the one their caller names. Torch has no full uint32 arithmetic on CUDA,
so there every 32-bit word is carried in an int64 tensor masked to its
low 32 bits: sums are masked after each add, rotations shift within the
mask. This is glue, not a port of a kernel: the reference's threefry is an
XLA computation, not a Pallas kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2), as jax's ``_threefry2x32_lowering``
    (``prng.py:883``). Operands are Python ints or int64 tensors holding
    uint32 values, broadcasting against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off."""
    return 0, int(seed) & _MASK


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: key i hashes the counters (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def _random_bits(key: Key, shape: Sequence[int],
                device: Union[str, torch.device]) -> torch.Tensor:
    """jax's 32-bit random bits of shape on device, as int64 holding
    uint32: the hash of the row-major uint64 iota's (high, low) words."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding, as XLA:CPU's fused
    multiply-add gives it: the f32 product is exact in f64, the f64 sum's
    error is kept (TwoSum), and a sum that lands exactly on a midpoint of
    the f32 grid is rounded towards the error's side."""
    p = a.double() * b.double()
    cd = c.double()
    t = p + cd
    bp = t - p
    err = (p - (t - bp)) + (cd - bp)
    r = t.float()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    nxt = torch.where(err > 0, torch.nextafter(r, inf),
                      torch.nextafter(r, -inf))
    # t is a midpoint when it lies halfway between r and the neighbour on
    # the error's side
    mid = (err != 0) & ((r.double() + nxt.double()) * 0.5 == t)
    return torch.where(mid, nxt, r)


def uniform(key: Key, shape: Sequence[int],
            device: Union[str, torch.device] = "cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)``: f32 on
    device."""
    bits = _random_bits(key, shape, device)
    # the top 23 bits as the mantissa of a float in [1, 2): below 2**30,
    # so the int32 cast keeps the bits
    one = 0x3F800000
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats            # floats * 1 + 0, at least 0: itself
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))

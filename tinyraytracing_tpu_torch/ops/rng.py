"""Planar counter-based RNG: Threefry-2x32-20 on component planes, bit for
bit the stream of ``tinyraytracing_tpu/ops/rng.py``.

PyTorch's uint32 support is partial (no shifts or adds on every backend),
so words are carried as int64 tensors holding values in [0, 2^32) and
every add or shift is masked back to 32 bits.

Stream layout (as in the JAX package):
- path key  = TF(master_key, (path_id, PATH_TAG))
- draw pair = TF(path_key, (bounce, draw_pair_index))
  giving 2 uniforms per block; uniform = (bits >> 8) * 2^-24 in [0, 1).

``split``, ``fold_in`` and ``uniform`` reproduce ``jax.random``'s bits for
a raw (2,) threefry key under ``jax_threefry_partitionable`` (the default
since JAX 0.5): ``fold_in(k, d) = TF(k, (0, d))``, ``split(k)[j] =
TF(k, (0, j))``, and flat element i of ``uniform(k, shape)`` is
``(y0 ^ y1) >> 9`` scaled by 2^-23, with (y0, y1) = TF(k, (0, i)). Keys
are pairs of Python ints, derived on the host: they cost no device launch.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
PATH_TAG = 0x9E3779B9


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 (5 groups of 4 rounds, a key injection after each
    group). Arguments are int64 tensors (or Python ints) of 32-bit words,
    broadcastable; returns a pair of int64 tensors of 32-bit words."""
    x0 = (c0 + k0) & _M
    x1 = (c1 + k1) & _M
    ks2 = k0 ^ k1 ^ _PARITY
    sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rounds = (_ROT[0], _ROT[1], _ROT[0], _ROT[1], _ROT[0])
    for block in range(5):
        for r in rounds[block]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        a, b = sched[block]
        x0 = (x0 + a) & _M
        x1 = (x1 + b + (block + 1)) & _M
    return x0, x1


def bits_to_uniform(bits):
    """32-bit words -> float32 uniform in [0, 1) with 24-bit resolution."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def master_key_data(seed: int) -> tuple[int, int]:
    """The (2,) key words of ``jax.random.PRNGKey(seed)`` (threefry
    default): (0, seed) for 0 <= seed < 2^32."""
    seed = int(seed)
    if not 0 <= seed <= _M:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return (0, seed)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` on a (k0, k1) key of Python ints."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split``: ``num`` keys, key j = ``fold_in(key, j)``."""
    return [fold_in(key, j) for j in range(num)]


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1) on ``device``."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(int(key[0]), int(key[1]), 0, i)
    u = ((y0 ^ y1) >> 9).to(torch.float32) * (1.0 / (1 << 23))
    return u.reshape(tuple(shape))


def path_keys(key_data, path_id):
    """Per-path key planes (k0, k1) from the master key words and (R,)
    integer path ids (taken modulo 2^32, like the JAX uint32 cast)."""
    pid = path_id.to(torch.int64) & _M
    return threefry2x32(int(key_data[0]), int(key_data[1]), pid, PATH_TAG)


def bounce_uniforms(k0, k1, bounce, n):
    """``n`` float32 (R,) uniform planes for this (path, bounce): a pure
    function of (path key, bounce, draw index)."""
    b = bounce.to(torch.int64) & _M
    out = []
    for blk in range((n + 1) // 2):
        r0, r1 = threefry2x32(k0, k1, b, blk)
        out.append(bits_to_uniform(r0))
        out.append(bits_to_uniform(r1))
    return out[:n]

"""Threefry-2x32-20 on int64 tensors holding 32-bit words: the counter
RNG whose stream the port's renderers draw from (path key = TF(master,
(path_id, PATH_TAG)); bounce draws = TF(path_key, (bounce, pair)) with
uniform = (bits >> 8) * 2^-24), written out here again so that the
reference and the keys the benchmark hands to the program depend on
nothing of the program."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
PATH_TAG = 0x9E3779B9


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds on ints or int64 tensors of 32-bit
    words (broadcastable); returns the two output words."""
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    ks2 = k0 ^ k1 ^ _PARITY
    sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rounds = (_ROT[0], _ROT[1], _ROT[0], _ROT[1], _ROT[0])
    for block in range(5):
        for r in rounds[block]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        a, b = sched[block]
        x0 = (x0 + a) & M32
        x1 = (x1 + b + (block + 1)) & M32
    return x0, x1


def fold_in(key, data: int) -> tuple[int, int]:
    """A new key from ``key`` (two ints) and a 32-bit word."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & M32)


def master_key(seed: int) -> tuple[int, int]:
    """The run's master key from a non-negative seed of any size: the low
    32 bits make the key (0, lo), the bits above are folded in."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    key = (0, seed & M32)
    hi = seed >> 32
    return fold_in(key, hi) if hi else key


def unit_key(master, unit: int) -> tuple[int, int]:
    """The key of a unit of work (a bucket, a pass, a step)."""
    return fold_in(master, unit)


def bits_to_uniform(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def path_keys(key, path_id):
    pid = path_id.to(torch.int64) & M32
    return threefry2x32(int(key[0]), int(key[1]), pid, PATH_TAG)


def bounce_uniforms(k0, k1, bounce: int, n: int):
    """``n`` float32 uniforms of each path at ``bounce``."""
    out = []
    for blk in range((n + 1) // 2):
        r0, r1 = threefry2x32(k0, k1, bounce & M32, blk)
        out += [bits_to_uniform(r0), bits_to_uniform(r1)]
    return out[:n]

"""Small-table lookups with the semantics of
``tinyraytracing_tpu/ops/lookup.py``.

The JAX package resolves tables of up to ``CHAIN_LIMIT`` rows with select
chains to avoid TPU gathers; on a GPU a gather is cheap, so here every
lookup is plain indexing. The chain's result for an index outside
[0, M) is the LAST row (its fill value) — misses carry mtl == -1 — and
that is reproduced exactly; past ``CHAIN_LIMIT`` the JAX code indexes
directly (negative indices wrap, others clamp), reproduced too.
"""

from __future__ import annotations

import torch

CHAIN_LIMIT = 64


def _rows(M: int, idx: torch.Tensor) -> torch.Tensor:
    i = idx.to(torch.int64)
    if M > CHAIN_LIMIT:
        return torch.clamp(torch.where(i < 0, i + M, i), 0, M - 1)
    return torch.where((i >= 0) & (i < M), i, M - 1)


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for integer ``rows`` of any shape, by
    ``index_select``: its backward adds the cotangent rows with
    ``index_add_`` (atomics on the card). ``table[rows]``'s backward sorts
    the indices first and then adds each run of equal rows in turn, which
    on the card is many times slower where many rows repeat, as in a
    gather from a material or light table (PERF.md, Findings)."""
    flat = torch.index_select(table, 0, rows.reshape(-1))
    return flat.reshape(*rows.shape, *table.shape[1:])


def chain_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (M,) or (M, C) table and an integer- or
    float-valued index tensor of any shape."""
    return gather_rows(table, _rows(table.shape[0], idx))


def chain_lookup_planes(table: torch.Tensor, idx: torch.Tensor):
    """Like chain_lookup for a (M, C) table, returned as a tuple of C planes."""
    rows = gather_rows(table, _rows(table.shape[0], idx))
    return tuple(rows[..., c] for c in range(table.shape[1]))

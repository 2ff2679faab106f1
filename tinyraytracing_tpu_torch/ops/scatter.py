"""Scatter-adds in a fixed order: renders and gradients that repeat
bitwise on the card.

The JAX package scatters with XLA, whose adds run in one fixed order, so
the same key gives the same image and the same gradient
(``tinyraytracing_tpu/integrator/fused_queue.py``: "Same key => same
image"). ``index_add_`` on a CUDA tensor adds with atomics, in whatever
order the threads arrive. The hand-written kernels of
``csrc/scatter_add.cu`` take its place on the card; neither has a TPU
counterpart; neither calls a library sort or scan. The image scatter
lets every kept position claim one of its row's 4 slots, and the row's
first claimant orders the row's positions and adds them; a call where a
row took more values sorts instead. The cotangent scatter always sorts.
The sort is a stable radix sort of their own over the kept rows' bits,
so the positions of one row form a run in ascending source position. The
plain versions sort with ``torch.sort(stable=True)`` (deterministic),
which gives the same runs. A kernel call allocates its scratch with
``torch.empty``, sized from the value count, the channels and the row
count alone, and reads nothing back to the host, so it can be captured
in a CUDA graph.

- ``scatter_add_rows(dst, dim, rows, src, keep)``, for the images (the
  queue's ``(3, n_pix + 1)`` image along dim 1, ``render_regen``'s
  ``(n_pix + R, 3)`` image along dim 0): each row gets its values added
  one at a time, in ascending position of ``rows``. On rows below
  ``keep`` the result is bitwise ``dst.cpu().index_add_(dim, rows, src)``:
  the CPU's ``index_add_`` adds in index order. A pixel takes at most
  ``spp`` values in one iteration, so each chain is short.
- ``scatter_add_rows_fixed(n_rows, rows, src)``, for the cotangents
  (``ops.lookup.gather_rows``' backward), where one row can take every
  lane of a bounce. Each row's values, in ascending position, are summed
  in chunks of ``FIXED_CHUNK`` from the row's first value, left to right;
  the chunk sums are summed the same way, level after level, until one
  value is left, which becomes the row of a zero tensor. The order depends
  on the row's values alone, never on the scheduling.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version: ``index_add_`` itself for the images,
``scatter_add_rows_fixed_plain`` for the cotangents. The plain versions
(``scatter_add_rows_plain``, ``scatter_add_rows_fixed_plain``) make the
same float adds in the same order with stock tensor ops on any device,
each a single correctly rounded add, so the kernels equal them bitwise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tinyraytracing_tpu_torch.utils import spans

FIXED_CHUNK = 32          # K: values a chunk sums left to right, per level


def _sorted_rows(rows: torch.Tensor):
    """(sorted int32 rows, int64 positions they came from): a stable sort,
    so equal rows keep ascending position."""
    return torch.sort(rows.reshape(-1).to(torch.int32), stable=True)


def _runs(srow: torch.Tensor):
    """(s, e): the run [s, e) of equal sorted rows that holds each
    position."""
    n = srow.numel()
    idx = torch.arange(n, device=srow.device)
    diff = srow[1:] != srow[:-1]
    true = torch.ones(1, dtype=torch.bool, device=srow.device)
    head, tail = torch.cat([true, diff]), torch.cat([diff, true])
    s = torch.cummax(torch.where(head, idx, 0), 0).values
    e = torch.flip(torch.cummin(torch.flip(torch.where(tail, idx + 1, n), (0,)),
                                0).values, (0,))
    return s, e


# device ops a kernel call issues (its scratch comes from torch.empty,
# which issues none): an image call's claims (or sort) and adds in one
# cooperative launch; a cotangent call's sort, then its sums
DEVICE_OPS = {"scatter_rows": 1, "scatter_fixed": 2}


def fixed_levels(n: int, k: int = FIXED_CHUNK) -> int:
    """Levels of the fixed-order reduction of ``n`` values: the least L >= 1
    with k**L >= n (every row is one value after them)."""
    levels, kpow = 1, k
    while kpow < n:
        kpow *= k
        levels += 1
    return levels


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def scatter_add_rows_plain(dst: torch.Tensor, dim: int, rows: torch.Tensor,
                           src: torch.Tensor, keep: int | None = None):
    """``dst.index_add_(dim, rows, src)`` with each row's adds in ascending
    position of ``rows``, on any device: a stable sort, each position's
    rank within its run of equal rows, then one add per rank, whose rows
    do not repeat. Rows at or past ``keep`` (default: all of ``dst``'s)
    are left alone. Updates ``dst`` in place and returns it."""
    n_dst = dst.shape[dim]
    keep = n_dst if keep is None else keep
    if rows.numel() == 0:
        return dst
    srow, perm = _sorted_rows(rows)
    rank = torch.arange(srow.numel(), device=srow.device) - _runs(srow)[0]
    use = (srow >= 0) & (srow < keep)
    if not bool(use.any()):
        return dst
    d, v = dst.movedim(dim, 0), src.movedim(dim, 0)
    for k in range(int(rank[use].max()) + 1):
        sel = torch.nonzero(use & (rank == k)).reshape(-1)
        r = srow[sel].to(torch.int64)
        d[r] = d[r] + v[perm[sel]]
    return dst


def scatter_add_rows_fixed_plain(n_rows: int, rows: torch.Tensor,
                                 src: torch.Tensor, k: int = FIXED_CHUNK):
    """The (n_rows, *src.shape[1:]) sums of ``src``'s rows by ``rows``, in
    the fixed order of ``scatter_add_rows_fixed``, on any device: level by
    level, each run's partial sums at positions [s, s + ceil(n_r / k**l))
    of its own range [s, s + n_r) of the sorted positions, as the kernel
    keeps them, each chunk summed by k steps of single adds."""
    n = rows.numel()
    C = math.prod(src.shape[1:])
    x = src.reshape(n, C)
    out = torch.zeros((n_rows, C), dtype=src.dtype, device=src.device)
    if n == 0:
        return out.reshape(n_rows, *src.shape[1:])
    srow, perm = _sorted_rows(rows)
    s, e = _runs(srow)
    nr = e - s
    q = torch.arange(n, device=srow.device) - s
    buf = x[perm]
    kpow = 1
    for level in range(fixed_levels(n, k)):
        m_in = (nr + kpow - 1) // kpow
        m_out = (m_in + k - 1) // k
        work = q < m_out
        if level > 0:
            work &= m_in > 1
        p = torch.nonzero(work).reshape(-1)
        first, cnt = s[p] + q[p] * k, m_in[p] - q[p] * k
        acc = buf[first]
        for t in range(1, k):
            ok = (cnt > t)[:, None]
            acc = torch.where(ok, acc + buf[torch.where(cnt > t, first + t, first)], acc)
        buf = buf.clone()
        buf[s[p] + q[p]] = acc
        kpow *= k
    head = q == 0
    out[srow[head].to(torch.int64)] = buf[head]
    return out.reshape(n_rows, *src.shape[1:])


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("scatter_add.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trt_scatter_scratch_words.argtypes = [I, I, I, I]
        lib.trt_scatter_scratch_words.restype = L
        lib.trt_scatter_rows.argtypes = [P, P, I, P, P, I, I, I, L, L, L, L, P]
        lib.trt_scatter_rows.restype = ctypes.c_int
        lib.trt_scatter_fixed.argtypes = [P, P, I, P, P, I, I, I, I, P]
        lib.trt_scatter_fixed.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def _check(name, x, dev, dtype=torch.float32):
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")


def _row_ids(rows: torch.Tensor, dev) -> torch.Tensor:
    """``rows`` flat, as the kernels read them (int64 or int32, no cast)."""
    if rows.device != dev or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("rows must be an integer tensor on the values' device")
    return rows.reshape(-1).contiguous()


def _scratch(lib, n: int, n_keys: int, C: int, fixed: bool, dev):
    """The call's scratch on the current card: int32 words whose count
    follows from the sizes and the card alone (``trt_scatter_scratch_words``),
    so a call can be captured in a CUDA graph; the kernel sets what it
    reads before reading it."""
    words = lib.trt_scatter_scratch_words(n, n_keys, C, int(fixed))
    if words < 0:
        raise RuntimeError(f"scatter kernel plan failed: cudaError {-1 - words}")
    return torch.empty(words, dtype=torch.int32, device=dev)


def scatter_add_rows_kernel(dst: torch.Tensor, dim: int, rows: torch.Tensor,
                            src: torch.Tensor, keep: int | None = None):
    """Launch ``trt_scatter_rows`` on PyTorch's current stream: ``dst``
    (2-D, float32, contiguous) updated in place as
    ``scatter_add_rows_plain`` updates it, and returned. One device op
    (the claims and the adds, or the sort and the adds, in one cooperative
    launch), nothing read back to the host. Raises on a CPU tensor or a
    failed launch."""
    if not dst.is_cuda:
        raise ValueError("scatter_add_rows_kernel needs CUDA tensors")
    _check("dst", dst, dst.device)
    _check("src", src, dst.device)
    if dim not in (0, 1) or dst.dim() != 2 or src.dim() != 2:
        raise ValueError("dst and src must be 2-D and dim 0 or 1")
    n = rows.numel()
    if src.shape[dim] != n or src.shape[1 - dim] != dst.shape[1 - dim]:
        raise ValueError(f"src {tuple(src.shape)} does not fit dst "
                         f"{tuple(dst.shape)} and {n} rows along dim {dim}")
    rows = _row_ids(rows, dst.device)
    if dst.shape[dim] >= 2**31 or n >= 2**30:
        raise ValueError("too many rows or values for int32 ids")
    keep = dst.shape[dim] if keep is None else max(0, min(keep, dst.shape[dim]))
    if n == 0:
        return dst
    C = dst.shape[1 - dim]
    d_row, d_col = dst.stride(dim), dst.stride(1 - dim)
    s_row, s_col = src.stride(dim), src.stride(1 - dim)
    lib = _lib()
    with torch.cuda.device(dst.device):
        scratch = _scratch(lib, n, keep, C, False, dst.device)
        err = lib.trt_scatter_rows(
            dst.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int64),
            src.data_ptr(), scratch.data_ptr(), n, C, keep, d_row, d_col,
            s_row, s_col, torch.cuda.current_stream(dst.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    spans.count("launches.scatter_rows")
    return dst


def scatter_add_rows_fixed_kernel(n_rows: int, rows: torch.Tensor,
                                  src: torch.Tensor):
    """Launch ``trt_scatter_fixed`` on PyTorch's current stream; returns
    what ``scatter_add_rows_fixed_plain`` returns (rows outside
    [0, n_rows) are left out). Two device ops (a cooperative launch that
    zeroes the output, sorts and gathers the values in order; then every
    level's sums), nothing read back to the host. Raises on a CPU tensor
    or a failed launch."""
    if not src.is_cuda:
        raise ValueError("scatter_add_rows_fixed_kernel needs CUDA tensors")
    n = rows.numel()
    if src.dtype != torch.float32 or src.shape[0] != n:
        raise ValueError(f"src must be float32 with {n} rows, got "
                         f"{src.dtype} {tuple(src.shape)}")
    rows = _row_ids(rows, src.device)
    if n_rows >= 2**31 or n >= 2**30:
        raise ValueError("too many rows or values for int32 ids")
    C = math.prod(src.shape[1:])
    x = src.reshape(n, C).contiguous()
    dev = src.device
    if not (n and C):
        return torch.zeros((n_rows, *src.shape[1:]), dtype=torch.float32, device=dev)
    out = torch.empty((n_rows, C), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, n, n_rows, C, True, dev)
        err = lib.trt_scatter_fixed(
            out.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int64),
            x.data_ptr(), scratch.data_ptr(), n, C, n_rows, FIXED_CHUNK,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_fixed kernel launch failed: cudaError {err}")
    spans.count("launches.scatter_fixed")    # one a call: both its launches
    return out.reshape(n_rows, *src.shape[1:])


def scatter_add_rows(dst: torch.Tensor, dim: int, rows: torch.Tensor,
                     src: torch.Tensor, keep: int | None = None):
    """``dst.index_add_(dim, rows, src)`` in ascending position of ``rows``
    for every row below ``keep`` (rows at or past it may be left alone):
    the kernel on a CUDA tensor, ``index_add_`` on a CPU tensor (it adds in
    index order there). Updates ``dst`` in place and returns it."""
    if dst.is_cuda:
        return scatter_add_rows_kernel(dst, dim, rows, src, keep)
    if dst.device.type == "cpu":
        return dst.index_add_(dim, rows, src)
    raise ValueError(f"no scatter_add_rows implementation for device {dst.device}")


def scatter_add_rows_fixed(n_rows: int, rows: torch.Tensor,
                           src: torch.Tensor):
    """The (n_rows, *src.shape[1:]) sums of ``src``'s rows by ``rows``
    (each in [0, n_rows)), in the fixed order of the module docstring: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if src.is_cuda:
        return scatter_add_rows_fixed_kernel(n_rows, rows, src)
    if src.device.type == "cpu":
        return scatter_add_rows_fixed_plain(n_rows, rows, src)
    raise ValueError(f"no scatter_add_rows_fixed implementation for device {src.device}")

"""The program's spans and counters, on the profiler's clock.

``span(name)`` times a stretch of host code, ``count(name, n)`` adds a
host integer to a counter, and ``recording()`` collects the spans opened
in its extent and each counter's change over it::

    with spans.recording() as rec:
        render(...)
    rec.spans   # [(name, start ns, end ns, parent index or -1, thread id)]
    rec.counts  # {counter: change}, counters that changed

Names are ``<layer>.<what>``; a span named ``*.sync`` covers only a host
read that waits on the device. Spans nest per thread: a span's parent is
the innermost span open on its own thread when it started (the autograd
engine's device thread has spans of its own). Outside ``recording()``
``span`` returns one shared object that does nothing; counters always
count (the kernel wrappers' ``launches.<kernel>``, for one).

Spans are stamped with ``time.time_ns()``: the Unix clock that
``torch.profiler``'s events carry, so a span and a kernel interval of one
profile compare directly, as do the spans of processes on one host.

Nothing here issues a device op: a span reads the host clock and a
counter takes a value the host already holds. So recording adds no device
op and no synchronisation, on or off. A count that the device holds goes
in with ``add(name, tensor)``, which keeps a reference to the tensor while
a recording is open; the recording sums each name's tensors as it ends,
into ``counts``: one read of the device, after the work it counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time

_COUNTS: dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_open: list | None = None          # the open recording's spans
_device: dict | None = None        # the open recording's device counts


@dataclasses.dataclass
class Recording:
    """What ``recording()`` collected; ``counts`` is filled as it ends."""

    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "index", "parent", "start")

    def __init__(self, name: str, rec: list):
        self.name, self.rec = name, rec

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        top = stack[-1] if stack else None
        self.parent = top.index if top is not None and top.rec is self.rec else -1
        with _lock:
            self.index = len(self.rec)
            self.rec.append(None)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        self.rec[self.index] = (self.name, self.start, end, self.parent,
                                threading.get_ident())
        return False


def span(name: str):
    """A context manager that records ``name`` over its extent while a
    recording is open."""
    rec = _open
    return _NO_SPAN if rec is None else _Span(name, rec)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    with _lock:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def add(name: str, value) -> None:
    """While a recording is open, count the device scalar ``value`` (a
    tensor holding a whole number) under ``name``; nothing otherwise. No
    device op: the tensor is kept and summed as the recording ends."""
    device = _device
    if device is not None:
        with _lock:
            device.setdefault(name, []).append(value.detach())


def _device_totals(device: dict) -> dict:
    import torch

    return {k: int(torch.stack(vs).double().sum().item()) for k, vs in device.items()}


@contextlib.contextmanager
def recording():
    """Record spans over the extent of the ``with``; yields the
    ``Recording``. One recording is open at a time."""
    global _open, _device
    if _open is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    with _lock:
        base = dict(_COUNTS)
    _open, _device = rec.spans, {}
    try:
        yield rec
    finally:
        device, _open, _device = _device, None, None
        with _lock:
            now = dict(_COUNTS)
        rec.counts = {k: v - base.get(k, 0) for k, v in now.items()
                      if v != base.get(k, 0)}
        rec.counts.update(_device_totals(device))

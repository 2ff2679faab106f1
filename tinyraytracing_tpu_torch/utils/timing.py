"""Wall-clock timing, the counterpart of
``tinyraytracing_tpu/utils/timing.py``.

The reference prints a single ``clock()`` delta — CPU time, which under
OpenMP overcounts by the thread count (RayTracingOnCPU/main.cpp:60-61,
116-117). This is a wall-clock timer that can wait for the device before
it stops: PyTorch returns before the card finishes, so pass
``sync=torch.cuda.synchronize`` when timing work on the card.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self, sync=None):
        self._sync = sync  # callable, e.g. torch.cuda.synchronize

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self.elapsed = time.perf_counter() - self.start
        return False

"""Host-side phase timing for `timings.json` (counterpart of the Stopwatch in
repconc_tpu/core/profiling.py). Device work is asynchronous under torch:
a phase that ends in a host copy (`.cpu()`, `.numpy()`) has waited for it."""
from __future__ import annotations

import contextlib
import time


class Stopwatch:
    """Wall-clock accumulator for host-side phase timing (encode/search/IO)."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0)

"""Profiler traces, named regions and host-side phase timing (counterpart
of repconc_tpu/core/profiling.py).

    from repconc_tpu_torch.core.profiling import annotate, trace

    with trace("/tmp/repconc_trace"):          # a Chrome trace in that dir
        for step, batch in enumerate(batches):
            with annotate("train_step", step_num=step):
                metrics = train_step(batch)

Device work is asynchronous under torch: a Stopwatch phase that ends in a
host copy (`.cpu()`, `.numpy()`) has waited for it.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Run torch.profiler over the block (CPU activities, and CUDA's where
    a card is present) and export a Chrome trace into log_dir; nothing
    when log_dir is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def annotate(name: str, **kwargs):
    """A named region of the trace; keyword arguments join the name, as
    StepTraceAnnotation's do (`train_step[step_num=3]`)."""
    if kwargs:
        name += "[" + ",".join(f"{k}={v}" for k, v in kwargs.items()) + "]"
    return torch.profiler.record_function(name)


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

    def summary(self) -> dict:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))

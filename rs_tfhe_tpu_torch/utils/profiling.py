"""Timing and tracing (rs_tfhe_tpu/utils/profiling.py): a timer that waits
for the device, a bootstraps-a-second counter (the framework's north-star
metric), and a `torch.profiler` trace written as a Chrome trace."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _first_tensor(x):
    """The first tensor of a tensor or a nested list, tuple or dict of them."""
    if isinstance(x, torch.Tensor):
        return x
    for leaf in (x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()):
        found = _first_tensor(leaf)
        if found is not None:
            return found
    return None


def force(x) -> None:
    """Wait until the device of `x` (a tensor, or a nested list, tuple or
    dict of tensors: the first one's device) has finished all its queued
    work. Work on the CPU is done when the call returns."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"force: no tensor in {type(x).__name__}")
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class Timer:
    """Named host-clock spans, each ending after the device has finished."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            force(sync_on)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.spans.items():
            lines.append(
                f"{name}: n={len(ts)} total={sum(ts):.3f}s "
                f"mean={np.mean(ts) * 1e3:.1f}ms min={min(ts) * 1e3:.1f}ms"
            )
        return "\n".join(lines)


def gate_throughput(gate_fn, a, b, ck, iters: int = 3) -> float:
    """Bootstrapped gates a second: `iters` chained calls (each output is the
    next input, so no call repeats another), one wait for the device, after
    one warm-up call."""
    force(gate_fn(a, b, ck))
    t0 = time.perf_counter()
    cur = a
    for _ in range(iters):
        cur = gate_fn(cur, b, ck)
    force(cur)
    return a.shape[0] / ((time.perf_counter() - t0) / iters)


@contextlib.contextmanager
def trace(path):
    """Profile the block with `torch.profiler` (the CPU, and the card where
    there is one) and write a Chrome trace to `path` (open it in
    chrome://tracing or Perfetto). A profiler that fails to start or stop
    raises: nothing is swallowed."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))

"""The reduction of a `torch.profiler` trace of the traced slice to what the
per-layer metrics and the result's `breakdown` read.

  - device activity: every event the profiler recorded on the device
    (kernels, copies, sets), as intervals; busy time is the length of their
    union, so overlapping activities count once;
  - span: from the first host event of the slice to the last event's end;
  - a layer's device time: the kernels whose name matches the layer's
    pattern in `kernels.json`, or the kernels launched by a host op whose
    name matches the layer's op pattern there (the op that launched a
    kernel, or one of that op's parents);
  - idle gaps: the stretches of the span with no device activity, each
    named by the innermost host event running at its middle ("python" where
    none was).
"""

from __future__ import annotations

import bisect
import collections
import json
import re
from pathlib import Path

import torch

TABLE = json.loads((Path(__file__).resolve().parent / "kernels.json").read_text())


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace markers and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class Trace:
    """The traced slice, in microseconds on the profiler's clock."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        # a host range also leaves an annotation on the device's timeline:
        # not an activity of the device
        self.device = [(e.time_range.start, e.time_range.end, e.name) for e in events
                       if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
        self.host = [e for e in events if e.device_type != cuda and not getattr(e, "is_async", False)]
        starts = [e.time_range.start for e in self.host] + [s for s, _, _ in self.device]
        ends = [e.time_range.end for e in self.host] + [t for _, t, _ in self.device]
        self.start = min(starts) if starts else 0.0
        self.end = max(ends) if ends else 0.0

    @property
    def span_us(self) -> float:
        return self.end - self.start

    @property
    def busy_us(self) -> float:
        return union_length((s, e) for s, e, _ in self.device)

    def kernels_us(self, pattern: str) -> float:
        """Device time of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name in self.device if rx.search(name))

    def launched_by_us(self, pattern: str) -> float:
        """Device time of the kernels launched by host ops whose name
        matches `pattern` (the launching op itself or one of its parents)."""
        rx = re.compile(pattern)
        total = 0.0
        for ev in self.host:
            kernels = getattr(ev, "kernels", None) or []
            if not kernels:
                continue
            parent = ev
            while parent is not None and not rx.search(parent.name):
                parent = parent.cpu_parent
            if parent is not None:
                total += sum(k.duration for k in kernels)
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing, each [name, seconds]."""
        ops = collections.Counter()
        for s, e, name in self.device:
            ops[_short(name)] += e - s
        gaps = collections.Counter()
        host = sorted(self.host, key=lambda ev: ev.time_range.start)
        host_starts = [ev.time_range.start for ev in host]
        end = self.start
        merged = sorted((s, e) for s, e, _ in self.device) + [(self.end, self.end)]
        for s, e in merged:
            if s > end:
                gaps[self._host_at((end + s) / 2, host, host_starts)] += s - end
            end = max(end, e)
        return {
            "device_ops": [[name, us / 1e6] for name, us in ops.most_common(top)],
            "idle_gaps": [[name, us / 1e6] for name, us in gaps.most_common(top)],
        }

    @staticmethod
    def _host_at(t: float, host, host_starts) -> str:
        """The innermost host event running at time t."""
        best = None
        for j in range(bisect.bisect_right(host_starts, t) - 1, -1, -1):
            ev = host[j]
            if ev.time_range.end >= t and (best is None or ev.time_range.start > best.time_range.start):
                best = ev
            if ev.cpu_parent is None:  # top-level events do not overlap: none before it runs at t
                break
        return best.name if best is not None else "python"

"""The program's own spans in a traced slice, and what the `program_span`
metrics of `metrics/` read from them.

The program opens a profiler range at each of its layers, named `tfhe.*`:
`tfhe.netlist.run`, `tfhe.netlist.group`, `tfhe.gate`,
`tfhe.rotate.<route>`, `tfhe.extract`, `tfhe.keyswitch`. They are host
events of the trace, on the clock of the device's activity. The profiler
links each device activity (kernel, copy, set) to the innermost op range
open at its launch: an ATen op, or a span itself where the package launches
its own kernel through ctypes. A device activity is *launched under* a span
when that range is the span or lies inside it. A span is a host event: it
never counts as device activity.

Only ATen ops and spans own device activity here: the profiler also lists
an op's kernels under any other host event whose id equals the op's (its own
markers such as `Command Buffer Full`, inside a launch), which would count
them twice.

A trace of a program without spans holds none: every reader here then
returns None, and the harness leaves the metric out.
"""

from __future__ import annotations

import re

from . import roofline

#: every span of the program starts with this
PREFIX = "tfhe."
ROTATE = r"^tfhe\.rotate\."
KEYSWITCH = r"^tfhe\.keyswitch$"
GATE = r"^tfhe\.gate$"


def _merged(pairs) -> list[tuple[float, float]]:
    """(start, end) pairs as sorted, disjoint intervals covering the same time."""
    merged: list = []
    for s, e in sorted(pairs):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(e, merged[-1][1]))
        else:
            merged.append((s, e))
    return merged


def intervals(trace, pattern: str) -> list[tuple[float, float]]:
    """The host time inside the spans whose name matches `pattern`, as
    sorted, disjoint intervals (a span inside another counts once)."""
    rx = re.compile(pattern)
    return _merged((ev.time_range.start, ev.time_range.end) for ev in trace.host if rx.search(ev.name))


def busy(trace) -> list[tuple[float, float]]:
    """The device's activity as sorted, disjoint intervals."""
    return _merged((s, e) for s, e, _ in trace.device)


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two lists of sorted, disjoint intervals."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def launched_under_us(trace, pattern: str) -> float:
    """Device time of the activities launched under a span whose name
    matches `pattern` (their durations summed, as `Trace.kernels_us` sums
    them). The owners are the ATen ops and the spans."""
    rx = re.compile(pattern)
    total = 0.0
    for ev in trace.host:
        kernels = getattr(ev, "kernels", None)
        if not kernels or not ("::" in ev.name or ev.name.startswith(PREFIX)):
            continue
        parent = ev
        while parent is not None and not rx.search(parent.name):
            parent = parent.cpu_parent
        if parent is not None:
            total += sum(k.duration for k in kernels)
    return total


def has_spans(trace) -> bool:
    return trace is not None and any(ev.name.startswith(PREFIX) for ev in trace.host)


def rotation_roofline(ctx):
    """Percent: the least time of the traced units' rotations
    (roofline.rotation_bound_s per call) over the device time launched
    under `tfhe.rotate.*`."""
    device_us = launched_under_us(ctx.trace, ROTATE) if has_spans(ctx.trace) else 0.0
    if device_us <= 0:
        return None
    bound_s = sum(roofline.rotation_bound_s(ctx.params, b) for u in ctx.units for b in u.groups)
    return 100.0 * bound_s / (device_us * 1e-6)


def key_switch_ms(ctx):
    """Device milliseconds launched under `tfhe.keyswitch`, per bootstrap
    of the traced units."""
    device_us = launched_under_us(ctx.trace, KEYSWITCH) if has_spans(ctx.trace) else 0.0
    bootstraps = sum(b for u in ctx.units for b in u.groups)
    if device_us <= 0 or not bootstraps:
        return None
    return device_us * 1e-3 / bootstraps


def gate_host_ms(ctx):
    """Host milliseconds inside the outermost `tfhe.gate` spans, per traced
    unit."""
    host_us = sum(e - s for s, e in intervals(ctx.trace, GATE)) if has_spans(ctx.trace) else 0.0
    if host_us <= 0 or not ctx.units:
        return None
    return host_us * 1e-3 / len(ctx.units)


def idle_in_program(ctx):
    """Percent of the traced slice's span in which the device is idle while
    the host is inside a `tfhe.*` span. Idle time outside every span is the
    caller's: its copies in and its reads back."""
    tr = ctx.trace
    if not has_spans(tr) or not tr.device or tr.span_us <= 0:
        return None
    program = intervals(tr, "^" + re.escape(PREFIX))
    idle_us = sum(e - s for s, e in program) - overlap_us(program, busy(tr))
    return 100.0 * idle_us / tr.span_us

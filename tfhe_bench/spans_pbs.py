"""What the `program_span` metrics of the LUT cells read from a traced slice:
the program's `tfhe.pbs` spans (one a programmable bootstrap, enclosing its
`tfhe.rotate.<route>`, `tfhe.extract` and `tfhe.keyswitch` spans), with the
owners and the clock of spans.py.

A trace of a program without the `tfhe.pbs` span holds none: every reader
here then returns None, and the harness leaves the metric out.
"""

from __future__ import annotations

import re

from . import spans

PBS = r"^tfhe\.pbs$"


def pbs_split_us(trace) -> tuple[float, float]:
    """(device time launched under a `tfhe.pbs` span, the part of it also
    launched under a `tfhe.rotate.*` span inside it), microseconds."""
    pbs, rotate = re.compile(PBS), re.compile(spans.ROTATE)
    total = rotated = 0.0
    for ev in trace.host:
        kernels = getattr(ev, "kernels", None)
        if not kernels or not ("::" in ev.name or ev.name.startswith(spans.PREFIX)):
            continue
        in_rotation, parent = False, ev
        while parent is not None and not pbs.search(parent.name):
            in_rotation = in_rotation or bool(rotate.search(parent.name))
            parent = parent.cpu_parent
        if parent is not None:
            us = sum(k.duration for k in kernels)
            total += us
            rotated += us if in_rotation else 0.0
    return total, rotated


def rest_share(ctx):
    """Percent of the device time launched under `tfhe.pbs` that no
    `tfhe.rotate.*` span inside it launched: the extract, the key switch,
    the test vectors' staging, the linear forms."""
    if not spans.has_spans(ctx.trace):
        return None
    total, rotated = pbs_split_us(ctx.trace)
    if total <= 0:
        return None
    return 100.0 * (total - rotated) / total


def host_ms(ctx):
    """Host milliseconds inside the outermost `tfhe.pbs` spans, per traced
    unit."""
    host_us = sum(e - s for s, e in spans.intervals(ctx.trace, PBS)) if spans.has_spans(ctx.trace) else 0.0
    if host_us <= 0 or not ctx.units:
        return None
    return host_us * 1e-3 / len(ctx.units)

"""What the per-layer metrics of `metrics/` read from a traced slice.

Each function takes the run's context (run.Context: the slice's units and
their bootstrapped calls, the trace reduction, the configuration's numbers)
and returns the metric's number, or None where the slice holds nothing for
it to read: the harness then leaves the metric out of the result.
"""

from __future__ import annotations

from . import roofline
from .trace import TABLE


def enqueue_ms(ctx):
    """Mean host milliseconds from the call into the timed entry until it
    returned, over the traced units."""
    if not ctx.units:
        return None
    return 1e3 * sum(u.enqueue_s for u in ctx.units) / len(ctx.units)


def rotation_roofline(ctx):
    """Percent: the least time of the traced units' rotations
    (roofline.rotation_bound_s per call) over the device time of the
    rotation kernels in the trace."""
    device_us = ctx.trace.kernels_us(TABLE["rotation_kernels"]) if ctx.trace else 0.0
    if device_us <= 0:
        return None
    bound_s = sum(roofline.rotation_bound_s(ctx.params, b) for u in ctx.units for b in u.groups)
    return 100.0 * bound_s / (device_us * 1e-6)


def key_switch_ms(ctx):
    """Device milliseconds of the key switch's product, per bootstrap: the
    kernels launched by the host ops `kernels.json` names for it
    (`key_switch_ops`) over the traced units' bootstraps."""
    if not ctx.trace:
        return None
    device_us = ctx.trace.launched_by_us(TABLE["key_switch_ops"])
    bootstraps = sum(b for u in ctx.units for b in u.groups)
    if device_us <= 0 or not bootstraps:
        return None
    return device_us * 1e-3 / bootstraps


def idle_share(ctx):
    """Percent of the traced slice's span in which nothing ran on the
    device."""
    if not ctx.trace or ctx.trace.span_us <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.span_us)

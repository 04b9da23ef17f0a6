"""What the `program_span` metric of the product cell reads from a traced
slice: the device time launched under the product's column stage,
`tfhe.radix.mul.columns` (inside `tfhe.radix.mul`, beside `.encode` and
`.pairs`; each encloses its calls' `tfhe.pbs` spans), with the owners and
the clock of spans.py. The cell's rotation roofline is spans.py's
`rotation_roofline`.

A trace of a program without the stage spans holds none: the reader then
returns None, and the harness leaves the metric out.
"""

from __future__ import annotations

from . import spans

COLUMNS = r"^tfhe\.radix\.mul\.columns$"


def columns_device_ms(ctx):
    """Device milliseconds launched under `tfhe.radix.mul.columns`, per
    traced unit."""
    device_us = spans.launched_under_us(ctx.trace, COLUMNS) if spans.has_spans(ctx.trace) else 0.0
    if device_us <= 0 or not ctx.units:
        return None
    return device_us * 1e-3 / len(ctx.units)

"""Per-layer metric `device.idle_in_program.add` (see spans.idle_in_program)."""

from tfhe_bench.spans import idle_in_program as read  # noqa: F401

"""Per-layer metric `device.idle_share.add` (see readers.idle_share)."""

from tfhe_bench.readers import idle_share as read  # noqa: F401

"""Per-layer metric `pbs.host_ms.radix` (see spans_pbs.host_ms)."""

from tfhe_bench.spans_pbs import host_ms as read  # noqa: F401

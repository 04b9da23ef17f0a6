"""Per-layer metric `gate.host_ms.add` (see spans.gate_host_ms)."""

from tfhe_bench.spans import gate_host_ms as read  # noqa: F401

"""Per-layer metric `netlist.enqueue_ms` (see readers.enqueue_ms)."""

from tfhe_bench.readers import enqueue_ms as read  # noqa: F401

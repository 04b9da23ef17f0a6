"""Per-layer metric `mul.columns_device_ms.mul` (see spans_mul.columns_device_ms)."""

from tfhe_bench.spans_mul import columns_device_ms as read  # noqa: F401

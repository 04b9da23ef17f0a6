"""Per-layer metric `keyswitch.span_device_ms.add` (see spans.key_switch_ms)."""

from tfhe_bench.spans import key_switch_ms as read  # noqa: F401

"""Per-layer metric `keyswitch.device_ms.add` (see readers.key_switch_ms)."""

from tfhe_bench.readers import key_switch_ms as read  # noqa: F401

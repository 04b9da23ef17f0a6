"""Per-layer metric `rotation.span_roofline.add` (see spans.rotation_roofline)."""

from tfhe_bench.spans import rotation_roofline as read  # noqa: F401

"""Per-layer metric `rotation.roofline.add` (see readers.rotation_roofline)."""

from tfhe_bench.readers import rotation_roofline as read  # noqa: F401

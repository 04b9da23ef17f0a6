"""Utilities: key serialization, profiling and the noise model (utils/noise.py)."""

from .profiling import Timer, force, gate_throughput, trace  # noqa: F401
from .serialization import (  # noqa: F401
    load_cloud_key,
    load_reenc_key,
    load_secret_key,
    save_cloud_key,
    save_reenc_key,
    save_secret_key,
)

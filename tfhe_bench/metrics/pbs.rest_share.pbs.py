"""Per-layer metric `pbs.rest_share.pbs` (see spans_pbs.rest_share)."""

from tfhe_bench.spans_pbs import rest_share as read  # noqa: F401

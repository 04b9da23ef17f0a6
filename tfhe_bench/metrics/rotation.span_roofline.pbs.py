"""Per-layer metric `rotation.span_roofline.pbs` (see spans.rotation_roofline),
at the LUT cells' ring, N=2048.

roofline.rotation_work counts the test vector once (2N words), as a shared
one is read. A call with a test vector a ciphertext (the radix add's pairs)
reads (B-1) * 2N words more: 16,384 bytes at B=2, 0.010% of the multi-bit
key's 161.2 MB, and that call's bound is the multiply-adds' (0.167 ms
against 0.048 ms of bytes), so the count moves nothing."""

from tfhe_bench.spans import rotation_roofline as read  # noqa: F401

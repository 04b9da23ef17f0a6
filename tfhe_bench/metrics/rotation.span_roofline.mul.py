"""Per-layer metric `rotation.span_roofline.mul` (see spans.rotation_roofline),
at the product cell's ring, N=4096, standard key: a request's 10 calls
bound by 864 * 0.944 ms of s8 limb products.

roofline.rotation_work counts the test vector once (2N words), as a shared
one is read. The product's calls with a test vector a ciphertext read (B-1)
* 2N words more: 16.7 MB at B=512, 7.3% of the key's 228.1 MB, and every
call's bound is the multiply-adds' (0.483 s against 0.073 ms of bytes at
B=512), so the count moves nothing."""

from tfhe_bench.spans import rotation_roofline as read  # noqa: F401

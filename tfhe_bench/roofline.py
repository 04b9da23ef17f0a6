"""The least time the blind rotation's work needs on one NVIDIA H100 (SXM,
published dense rates), counted from the parameter set, the key kind and
the batch alone: never from the kernel, the instance or the route that ran.

Work of one rotation call of B ciphertexts:
  bytes: the bootstrapping key read once (int32 words), the ciphertexts in
      (B * (n0+1) words), the test vector (2N) and the accumulators out
      (B * 2N);
  multiply-adds of the exact negacyclic products, schoolbook, exact mod 2^32:
      standard key: B * n0 * 2L * 2 * N^2 (n0 external products);
      multi-bit key at B <= mb_route_batch_cap: B * (n0/2) * 2L * 2 * N^2
      (one product a pair of key bits, against the sum of the four rotated
      patterns, the least-time form).
  Least time = max(bytes / HBM rate, the faster of: the multiply-adds as
  32-bit products on the CUDA cores, or as s8 byte-limb products on the tensor
  cores, one limb of the key's word per 8 bits it carries).

An FFT or NTT rotation does other work; a benchmark that measures one
counts it anew.
"""

from __future__ import annotations

from .reference import Params

#: NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s; int32 multiply-adds/s
#: on the CUDA cores (132 SMs x 128 lanes x 1.98 GHz / 2, IMAD issue); s8
#: multiply-adds/s on the tensor cores (1,979 TOPS / 2)
HBM_BYTES_S = 3.35e12
MAC32_S = 16.75e12
MAC8_S = 989.5e12


def key_limbs(p: Params) -> int:
    """Byte limbs of a key word: ceil((32 - bsk_round_bits) / 8)."""
    return -(-(32 - p.bsk_round_bits) // 8)


def rotation_work(p: Params, batch: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one rotation call of `batch` ciphertexts."""
    n, two_l = p.n1, 2 * p.l
    steps, key_rows = (p.n0 // 2, 4) if p.takes_mb(batch) else (p.n0, 1)
    key_bytes = 4 * steps * key_rows * two_l * 2 * n
    io_bytes = 4 * (batch * (p.n0 + 1) + 2 * n + batch * 2 * n)
    macs = batch * steps * two_l * 2 * n * n
    return key_bytes + io_bytes, macs


def rotation_bound_s(p: Params, batch: int) -> float:
    """Least seconds of one rotation call of `batch` ciphertexts."""
    nbytes, macs = rotation_work(p, batch)
    compute = min(macs / MAC32_S, macs * key_limbs(p) / MAC8_S)
    return max(nbytes / HBM_BYTES_S, compute)

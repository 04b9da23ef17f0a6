"""Sample extraction: TRLWE -> LWE at a coefficient index.

Reference: rs-tfhe trlwe.rs:106-136. The extracted mask is
p[i] = a[(k - i) mod* N] with negacyclic sign: a gather with a static index
pattern, computed on the tensor's device (no host-to-device copy, so a chain
of bootstraps never waits for the host). Exact negation is used where the
reference uses MAX - x (see torus.neg_torus).
"""

from __future__ import annotations

import torch

from ..torus import neg_torus


def sample_extract(trlwe: torch.Tensor, k: int = 0) -> torch.Tensor:
    """int32 [..., 2, N] -> LWE lv1 [..., N+1] extracting coefficient k."""
    a = trlwe[..., 0, :]
    b = trlwe[..., 1, :]
    n = a.shape[-1]
    idx = torch.remainder(k - torch.arange(n, device=trlwe.device), 2 * n)
    wrap = idx >= n
    vals = a[..., torch.where(wrap, idx - n, idx)]
    p = torch.where(wrap, neg_torus(vals), vals)
    return torch.cat([p, b[..., k : k + 1]], dim=-1)


def sample_extract_to_lv0_width(trlwe: torch.Tensor, n0: int, k: int = 0) -> torch.Tensor:
    """The reference's truncating sample_extract_index_2 (trlwe.rs:122-136),
    as rs_tfhe_tpu/ops/extract.py:33-54: the index arithmetic runs with n0 in
    place of the ring size, p[i] = a[k-i] for i <= k else -a[n0 + k - i],
    body b[k] — not the first n0 entries of the full extract. The result is a
    hybrid ciphertext that decrypts under neither key; the reference used it
    for a MUX its tests never run, and no path of the port needs it."""
    a = trlwe[..., 0, :]
    b = trlwe[..., 1, :]
    idx = torch.arange(n0, device=trlwe.device)
    wrap = idx > k
    vals = a[..., torch.where(wrap, n0 + k - idx, k - idx)]
    p = torch.where(wrap, neg_torus(vals), vals)
    return torch.cat([p, b[..., k : k + 1]], dim=-1)

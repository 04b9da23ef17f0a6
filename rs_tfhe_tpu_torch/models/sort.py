"""Data-oblivious encrypted sorting: bitonic networks, one batched dispatch
per stage, as rs_tfhe_tpu/models/sort.py computes it, bit for bit.

FHE evaluation cannot branch on encrypted data, so a sort is a static
compare-exchange network. All K/2 exchanges of a bitonic stage are
independent, so each stage is one batched comparator and one batched
swap-select over every pair (and any batch axes), O(log^2 K) stages.

Two integer representations, as in the rest of models/:
  - bit vectors  [K, ..., W, n0+1]  (gate circuits: models.circuits)
  - radix digits [K, ..., D, n0+1]  (LUT arithmetic: models.arithmetic)
The leading axis is the one sorted. The inputs are never written: every
stage builds its result with `index_copy`, out of place.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import gates
from ..key import CloudKey
from ..tlwe import lwe_trivial_message
from . import arithmetic
from .circuits import greater_than


def _bitonic_schedule(k: int):
    """Static compare-exchange schedule for a k-element bitonic network (k a
    power of two): a list of stages (lo, hi, desc), numpy index arrays of the
    pair endpoints and a bool mask of the pairs whose run sorts descending.
    log2(k)*(log2(k)+1)/2 stages of k/2 pairs each."""
    if k <= 0 or k & (k - 1):
        raise ValueError(f"a bitonic network needs a power of two, got {k}")
    stages = []
    size = 2
    while size <= k:
        stride = size // 2
        while stride >= 1:
            i = np.arange(k)
            lo = i[(i % (2 * stride)) < stride]
            hi = lo + stride
            desc = (lo & size) != 0
            stages.append((lo, hi, desc))
            stride //= 2
        size *= 2
    return stages


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p *= 2
    return p


def _run_network(x: torch.Tensor, exchange) -> torch.Tensor:
    """Drive the schedule over x [Kp, ...]; `exchange(a, b, desc)` returns a
    stage's (new_lo, new_hi). Each stage makes a new tensor."""
    for lo, hi, desc in _bitonic_schedule(x.shape[0]):
        lo_t = torch.as_tensor(lo, device=x.device)
        hi_t = torch.as_tensor(hi, device=x.device)
        new_lo, new_hi = exchange(x[lo_t], x[hi_t], desc)
        x = x.index_copy(0, lo_t, new_lo).index_copy(0, hi_t, new_hi)
    return x


def _stage_select(swap: torch.Tensor, desc: np.ndarray) -> torch.Tensor:
    """Flip the swap bit on the descending pairs: the plaintext direction, so
    the flip is the bootstrap-free NOT, chosen per pair by a static mask."""
    if not desc.any():
        return swap
    mask = torch.as_tensor(desc, device=swap.device).reshape(desc.shape[0], *([1] * (swap.dim() - 1)))
    return torch.where(mask, gates.not_(swap), swap)


def _finish(x: torch.Tensor, k: int, descending: bool) -> torch.Tensor:
    """Order the network's ascending result and drop the padding, which
    sorted to the top end (torch has no negative step: flip)."""
    if descending:
        return torch.flip(x, dims=[0])[x.shape[0] - k:]
    return x[:k]


def sort_bits(x: torch.Tensor, ck: CloudKey, descending: bool = False) -> torch.Tensor:
    """Sort K encrypted W-bit unsigned integers (ascending by default).

    x: int32 [K, ..., W, n0+1] bit vectors (LSB first, bit_utils layout);
    returns the same shape with the K axis sorted. A K that is not a power of
    two is padded with trivial MAX sentinels, which sort to the far end and
    are sliced off. Per stage: one batched `greater_than` and one MUX batch
    that computes both swap outputs.
    """
    k = x.shape[0]
    if k <= 1:
        return x
    kp = _next_pow2(k)
    if kp != k:
        ones = gates.constant(True, 1, ck.params, device=x.device)[0]
        x = torch.cat([x, ones.expand(kp - k, *x.shape[1:])], dim=0)

    def exchange(a, b, desc):
        gt = greater_than(a, b, ck)  # [P, ..., n0+1]
        s = _stage_select(gt, desc)
        sel = s[None, ..., None, :].expand(2, *a.shape)
        # one MUX batch gives both outputs: row 0 the min side (lo), row 1
        # the max side (hi) of each ascending pair
        out = gates.mux(sel, torch.stack([b, a]), torch.stack([a, b]), ck)
        return out[0], out[1]

    return _finish(_run_network(x, exchange), k, descending)


def top_k_bits(x: torch.Tensor, k: int, ck: CloudKey, largest: bool = True) -> torch.Tensor:
    """The k largest (or smallest) of K encrypted integers, sorted: the full
    network, then a slice."""
    return sort_bits(x, ck, descending=largest)[:k]


def sort_radix(x: torch.Tensor, ck: CloudKey, base_bits: int = 3, descending: bool = False,
               multi_value: bool = False) -> torch.Tensor:
    """Sort K encrypted radix integers [K, ..., D, n0+1] along the K axis.

    Each stage costs one batched `compare_radix` and one batched
    `select_radix` that gives both swap outputs; the select's refresh keeps
    every element at fresh-digit noise. `multi_value` goes to the comparator.
    Padding digits are trivial base-1, so the sentinel is the largest value.
    """
    k = x.shape[0]
    if k <= 1:
        return x
    kp = _next_pow2(k)
    if kp != k:
        base = 1 << base_bits
        maxdig = lwe_trivial_message(
            torch.full((kp - k, *x.shape[1:-1]), base - 1, dtype=torch.int64, device=x.device),
            2 * base, ck.params.n0, x.device,
        )
        x = torch.cat([x, maxdig], dim=0)

    def exchange(a, b, desc):
        _, gt, _ = arithmetic.compare_radix(a, b, ck, base_bits, multi_value=multi_value)
        s = _stage_select(gt, desc)
        out = arithmetic.select_radix(
            s[None].expand(2, *s.shape), torch.stack([b, a]), torch.stack([a, b]), ck, base_bits
        )
        return out[0], out[1]

    return _finish(_run_network(x, exchange), k, descending)

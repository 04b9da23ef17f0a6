"""The benchmark's own keys and encryptions, drawn from the run's seed in
plain PyTorch on the device, in a few large calls.

Nothing here comes from the program: the program receives copies of the
arrays on the device (program.py), and the reference (reference.py) reads
the arrays themselves. The key switching key is kept as rows int32
[N*t*base, n0+1]; the program splits them into its own limb table.
"""

from __future__ import annotations

import torch

from .reference import MU, TORUS_BITS, Keys, Params, circulant, wrap

_TWO32 = float(1 << TORUS_BITS)


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any integer)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _uniform(g: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=g, dtype=torch.int32, device=g.device)


def _noise(g: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Torus noise: N(0, alpha) * 2^32, truncated toward zero."""
    x = torch.randn(shape, generator=g, dtype=torch.float64, device=g.device)
    return (x * (alpha * _TWO32)).to(torch.int32)


def _dot(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> over the last axis as int64 (s binary)."""
    return (a.to(torch.int64) * s.to(torch.int64)).sum(-1)


def lwe_encrypt(g: torch.Generator, s: torch.Tensor, mu: torch.Tensor, alpha: float) -> torch.Tensor:
    """LWE encryptions of torus words mu int32 [R] under s: [R, n+1]."""
    a = _uniform(g, (mu.shape[0], s.shape[0]))
    b = wrap(mu.to(torch.int64) + _noise(g, alpha, mu.shape) + _dot(a, s))
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)


def encrypt_bits(g: torch.Generator, s: torch.Tensor, bits: torch.Tensor, alpha: float) -> torch.Tensor:
    """+/-1/8 encryptions of bool [...] -> int32 [..., n+1]."""
    mu = torch.where(bits.reshape(-1), MU, -MU).to(torch.int32)
    return lwe_encrypt(g, s, mu, alpha).reshape(*bits.shape, s.shape[0] + 1)


def _trgsw(g: torch.Generator, s1: torch.Tensor, msg: torch.Tensor, p: Params) -> torch.Tensor:
    """TRGSW encryptions of small integers msg int32 [P] under s1:
    [P, 2L, 2, N], masks on the 2^bsk_round_bits grid and bodies rounded to
    it, the gadget Bg^-(i+1) * msg on row i's mask and row L+i's body at
    coefficient 0."""
    n, l, rb = p.n1, p.l, p.bsk_round_bits
    low = (1 << rb) - 1
    a = _uniform(g, (msg.shape[0], 2 * l, n)) & ~low
    e = _noise(g, p.alpha_lv1, a.shape)
    circ = circulant(s1.reshape(1, 1, n), torch.float64)  # exact: |sum| <= N * 2^31
    prod = (a.reshape(-1, n).to(torch.float64) @ circ).to(torch.int64).reshape(a.shape)
    b = wrap(e.to(torch.int64) + prod)
    if rb:
        b = (b + (1 << (rb - 1))) & ~low
    for i in range(l):
        scaled = msg << (TORUS_BITS - (i + 1) * p.bgbit)
        a[:, i, 0] += scaled
        b[:, i + l, 0] += scaled
    return torch.stack([a, b], dim=-2)


def _ksk_rows(g: torch.Generator, s0: torch.Tensor, s1: torch.Tensor, p: Params) -> torch.Tensor:
    """Row (i, j, k) encrypts k * s1[i] / base^(j+1) under s0; rows with
    k = 0 are zero."""
    base = p.ks_base
    k = torch.arange(base, dtype=torch.int64, device=s1.device)
    shifts = TORUS_BITS - p.basebit * torch.arange(1, p.iks_t + 1, dtype=torch.int64, device=s1.device)
    mu = (k[None, None, :] * s1.to(torch.int64)[:, None, None]) << shifts[None, :, None]
    rows = lwe_encrypt(g, s0, wrap(mu.reshape(-1)), p.alpha_lv0)
    rows[torch.arange(rows.shape[0], device=rows.device) % base == 0] = 0
    return rows


def make_keys(seed: int, p: Params, device) -> Keys:
    """Secret keys, test vector, bootstrapping keys and key switching key
    from `seed`, on `device`."""
    g = generator(seed, device)
    lv0 = torch.randint(0, 2, (p.n0,), generator=g, dtype=torch.int32, device=device)
    lv1 = torch.randint(0, 2, (p.n1,), generator=g, dtype=torch.int32, device=device)
    testvec = torch.zeros((2, p.n1), dtype=torch.int32, device=device)
    testvec[1] = MU
    bsk = _trgsw(g, lv1, lv0, p)
    ksk = _ksk_rows(g, lv0, lv1, p)
    bsk_mb = None
    if p.multibit:
        s1, s2 = lv0[0::2], lv0[1::2]
        inds = torch.stack([(1 - s1) * (1 - s2), s1 * (1 - s2), (1 - s1) * s2, s1 * s2], dim=1)
        bsk_mb = _trgsw(g, lv1, inds.reshape(-1), p).reshape(p.n0 // 2, 4, 2 * p.l, 2, p.n1)
    return Keys(lv0=lv0, lv1=lv1, testvec=testvec, bsk=bsk, ksk_rows=ksk, bsk_mb=bsk_mb)

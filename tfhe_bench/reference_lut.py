"""The plain reference of the timed LUT path: programmable bootstrapping and
radix addition in plain PyTorch, written from the published equations
(rs-tfhe lut/generator.rs, lut/encoder.rs, bootstrap/lut.rs; the TFHE-rs
radix integer layout) and the configuration file's numbers alone.

It imports nothing of the program, as reference.py, whose plain helpers it
reuses (the rotations, the extract, the key switch and their float64
bounds: reference.polymul and reference.key_switch raise where a sum could
pass 2^53, at N=2048, L=3, Bg=2^8 a product sums 2^20.6 terms below 2^31 a
term). What it adds:

  encode(m) = m * 2^32 / (2 * modulus): the message slots fill half the
      torus, the other half is their negacyclic image (the padding bit);
  decode(ct) = round(phase * 2 * modulus / 2^32) mod modulus;
  testvec_of(f) = the trivial TRLWE (0, v) with
      v[i] = encode(f(x)) on the box of x, i in [x*N/m, (x+1)*N/m) rounded,
      rotated left by N/(2m) (half a box, so each message's phase lands in
      the middle of its box), the N/(2m) coefficients that wrap negated;
  lut_bootstrap(ct, tv) = key_switch(sample_extract(rotate(ct, tv))), the
      rotation against `tv` shared [2, N] or per ciphertext [B, 2, N], the
      multi-bit rotation where the calling batch takes it
      (Params.takes_mb: the configuration's route rule);
  add_radix(a, b): per digit i, s = a_i + b_i + carry, then one call of the
      pair (s, s) against the per-ciphertext test vectors (s mod 2^b,
      s div 2^b) for digits 0..D-2, and one call of s against s mod 2^b for
      the last.

Departures from the published description, each to match what the
deployment runs:
  - encode floors m * 2^32 / (2m) in integers; rs-tfhe truncates the f64
    product. They agree where 2m divides 2^32 (every power-of-two modulus,
    16 here);
  - the box bounds round half up in integers (generator.rs's div_round),
    the same;
  - the key switch's output and the extract are this repository's (the full
    lv1 LWE is key-switched; reference.py's docstring);
  - the radix add bootstraps each digit's sum twice in one call (per-row
    test vectors) where TFHE-rs extracts message and carry with two calls.
"""

from __future__ import annotations

import dataclasses

import torch

from . import reference as R
from .keygen import lwe_encrypt


def encode(m: torch.Tensor, modulus: int) -> torch.Tensor:
    """int32 torus words of messages `m` (any integer tensor), mod modulus."""
    m = torch.remainder(m.to(torch.int64), modulus)
    return R.wrap(m * (1 << R.TORUS_BITS) // (2 * modulus))


def decode(ct: torch.Tensor, s: torch.Tensor, modulus: int) -> torch.Tensor:
    """int64 messages of LWE ciphertexts [..., n+1] under s: the phase
    rounded to the nearest slot, mod modulus."""
    dot = (ct[..., :-1].to(torch.int64) * s.to(torch.int64)).sum(-1)
    phase = torch.remainder(ct[..., -1].to(torch.int64) - dot, 1 << R.TORUS_BITS)
    return torch.remainder((phase * 2 * modulus + (1 << (R.TORUS_BITS - 1))) >> R.TORUS_BITS, modulus)


def encrypt(g: torch.Generator, s: torch.Tensor, m: torch.Tensor, modulus: int, alpha: float) -> torch.Tensor:
    """LWE encryptions of messages m [...] under s: int32 [..., n+1]."""
    mu = encode(m.reshape(-1), modulus)
    return lwe_encrypt(g, s, mu, alpha).reshape(*m.shape, s.shape[0] + 1)


def _div_round(a: int, b: int) -> int:
    return (a + b // 2) // b


def testvec_of(f, modulus: int, p: R.Params, device) -> torch.Tensor:
    """The test vector of `f` (message -> message) at `modulus`: int32
    [2, N], mask row zero."""
    n = p.n1
    values = torch.zeros(n, dtype=torch.int64)
    for x in range(modulus):
        values[_div_round(x * n, modulus) : _div_round((x + 1) * n, modulus)] = int(
            encode(torch.tensor(f(x)), modulus))
    offset = _div_round(n, 2 * modulus)
    rotated = torch.roll(values, -offset)
    rotated[n - offset :] = 0 - rotated[n - offset :]
    return torch.stack([torch.zeros(n, dtype=torch.int32), R.wrap(rotated)]).to(device)


def lut_bootstrap(ct: torch.Tensor, tv: torch.Tensor, keys: R.Keys, p: R.Params, group_batch: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Programmable bootstrap of lv0 ciphertexts [B, n0+1] against `tv`
    ([2, N] or [B, 2, N]), bootstrapped by the timed path in calls of
    `group_batch` ciphertexts, which decides the rotation. TF32 is turned
    off, so that the control's float32 products are float32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with_tv = dataclasses.replace(keys, testvec=tv)
    rot = R.rotate_mb if keys.bsk_mb is not None and p.takes_mb(group_batch) else R.rotate
    return R.key_switch(R.sample_extract(rot(ct, with_tv, p, dtype)), keys, p, dtype)


def add_radix(a: torch.Tensor, b: torch.Tensor, keys: R.Keys, p: R.Params, base_bits: int,
              dtype=torch.float64) -> torch.Tensor:
    """R requests' radix adds at once: a, b int32 [R, D, n0+1] digit vectors
    (least significant first) -> the sums [R, D, n0+1]. Each request's
    calls are the timed path's (pairs of 2 ciphertexts, the last digit
    alone), which decide the rotation; the rows of all requests go through
    each call together (a row's result depends on that row alone)."""
    r, d = a.shape[:2]
    base = 1 << base_bits
    mod_tv = testvec_of(lambda x: x % base, 2 * base, p, a.device)
    div_tv = testvec_of(lambda x: x // base, 2 * base, p, a.device)
    pair_tv = torch.stack([mod_tv, div_tv]).repeat(r, 1, 1)  # [2R, 2, N]: (mod, div) a request
    outs, carry = [], None
    for i in range(d):
        s = a[:, i] + b[:, i]
        if carry is not None:
            s = s + carry
        if i + 1 < d:
            pair = torch.stack([s, s], dim=1).reshape(2 * r, -1)
            res = lut_bootstrap(pair, pair_tv, keys, p, 2, dtype).reshape(r, 2, -1)
            outs.append(res[:, 0])
            carry = res[:, 1]
        else:
            outs.append(lut_bootstrap(s, mod_tv, keys, p, 1, dtype))
    return torch.stack(outs, dim=1)


def digits_of(values: torch.Tensor, num_digits: int, base_bits: int) -> torch.Tensor:
    """int64 [..., num_digits] base-2^b digits of non-negative integers,
    least significant first."""
    shifts = base_bits * torch.arange(num_digits, device=values.device)
    return (values.to(torch.int64).unsqueeze(-1) >> shifts) & ((1 << base_bits) - 1)

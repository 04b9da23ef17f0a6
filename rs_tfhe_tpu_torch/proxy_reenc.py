"""LWE proxy re-encryption: re-key ciphertexts Alice -> Bob without decryption
(reference proxy_reenc.rs; rs_tfhe_tpu/proxy_reenc.py).

Two ways to make the re-encryption key:
  - symmetric (both secret keys at hand, e.g. key rotation): the table rows
    are encryptions under Bob's key, made like the key-switching key's
    (tlwe.lwe_encrypt_rows_limbs);
  - asymmetric (Bob's public key only): the public key is 2n encryptions of
    zero, and a public-key encryption is a random +/-1/0 subset sum of them
    plus fresh noise, an exact int8 product (ops.poly.exact_dot_i8).

Re-encryption itself is the key switch's digit-decompose-and-subtract
(ops.keyswitch.digit_select_subtract) over a whole batch.
"""

from __future__ import annotations

import torch
from torch import nn

from .key import SecretKey
from .ops.keyswitch import digit_select_subtract
from .ops.poly import exact_dot_i8
from .params import TORUS_BITS, TfheParams
from .tlwe import bool_mu, lwe_encrypt_rows_limbs, lwe_encrypt_torus
from .torus import (
    OsRandom,
    TORUS_DTYPE,
    gaussian_torus,
    planar_limbs,
    random_key,
    recombine_planar,
    uniform_torus,
    wrap_i32,
)


class PublicKeyLv0(nn.Module):
    """`size` (2*n0 by default) encryptions of zero under the owner's lv0
    key (reference proxy_reenc.rs:95-153): `encryptions` int32 [size, n0+1]
    and their planar limbs `limbs` int8 [size, 4*W] (W: n0+1 rounded up to
    8) for the exact subset-sum product."""

    def __init__(self, encryptions: torch.Tensor, params: TfheParams):
        super().__init__()
        self.params = params
        self.register_buffer("encryptions", encryptions)
        self.register_buffer("limbs", planar_limbs(encryptions))

    @classmethod
    def generate(
        cls, generator: torch.Generator | OsRandom, sk_lv0: torch.Tensor, params: TfheParams,
        size: int | None = None, alpha: float | None = None,
    ) -> "PublicKeyLv0":
        size = 2 * params.n0 if size is None else size
        alpha = params.tlwe_lv0.alpha if alpha is None else alpha
        zeros = torch.zeros(size, dtype=TORUS_DTYPE, device=sk_lv0.device)
        return cls(lwe_encrypt_torus(generator, sk_lv0, zeros, alpha), params)

    def encrypt_torus(self, generator: torch.Generator | OsRandom, mu: torch.Tensor, alpha: float) -> torch.Tensor:
        """Public-key encryption of torus messages mu (int32 [...]): each
        zero encryption joins with coefficient 0, +1 or -1 (probabilities
        1/2, 1/4, 1/4), plus fresh body noise (reference
        proxy_reenc.rs:168-200). Returns int32 [..., n0+1]."""
        dev = self.limbs.device
        size = self.encryptions.shape[0]
        include = (uniform_torus(generator, (*mu.shape, size), device=dev) & 1).bool()
        sign = (uniform_torus(generator, (*mu.shape, size), device=dev) & 1).bool()
        coeff = torch.where(include, torch.where(sign, 1, -1), 0).to(torch.int8)
        acc = exact_dot_i8(coeff, self.limbs)  # [..., 4*W] exact int32
        w = self.limbs.shape[-1] // 4
        combo = recombine_planar(acc.reshape(*acc.shape[:-1], 4, w))[..., : self.params.n0 + 1]
        combo[..., -1] += mu + gaussian_torus(generator, alpha, mu.shape, device=dev)
        return combo

    def encrypt_bool(self, generator: torch.Generator | OsRandom, msg, alpha: float) -> torch.Tensor:
        return self.encrypt_torus(generator, bool_mu(msg, self.limbs.device), alpha)


class ProxyReencryptionKey(nn.Module):
    """Decomposed encryptions of the source key under the target key
    (reference proxy_reenc.rs:224-421): `table_limbs` int8
    [n0 * t * base, 4*W], the planar limbs of the rows, the rows of digit
    k = 0 zero."""

    def __init__(self, table_limbs: torch.Tensor, basebit: int, t: int, params: TfheParams):
        super().__init__()
        self.params = params
        self.basebit = basebit
        self.t = t
        self.register_buffer("table_limbs", table_limbs)

    @property
    def base(self) -> int:
        return 1 << self.basebit


def _reenc_plaintexts(key_from: torch.Tensor, basebit: int, t: int) -> torch.Tensor:
    """mu[i, j, k] = (k * key_from[i]) << (32 - (j+1)*basebit), flat int32:
    the exact integers of the reference's f64 formula (proxy_reenc.rs:313,
    :408)."""
    dev = key_from.device
    ks = torch.arange(1 << basebit, dtype=torch.int64, device=dev)
    shifts = torch.tensor([TORUS_BITS - (j + 1) * basebit for j in range(t)], dtype=torch.int64, device=dev)
    mu = (ks[None, None, :] * key_from.to(torch.int64)[:, None, None]) << shifts[None, :, None]
    return wrap_i32(mu.reshape(-1))


def _digit_zero_rows(n: int, basebit: int, t: int, device) -> torch.Tensor:
    return torch.arange(n * t << basebit, device=device) % (1 << basebit) == 0


def _decomposition(params: TfheParams, alpha, basebit, t) -> tuple[float, int, int]:
    g = params.trgsw_lv1
    return (params.ksk_alpha if alpha is None else alpha, g.basebit if basebit is None else basebit,
            g.iks_t if t is None else t)


def new_symmetric(
    generator: torch.Generator | OsRandom, key_from: torch.Tensor, key_to: torch.Tensor,
    params: TfheParams, alpha: float | None = None, basebit: int | None = None, t: int | None = None,
) -> ProxyReencryptionKey:
    """Both secret keys at hand (reference proxy_reenc.rs:362-420). The
    rows' masks are the threefry stream of a key drawn from `generator`,
    their noise comes from `generator`."""
    alpha, basebit, t = _decomposition(params, alpha, basebit, t)
    limbs = lwe_encrypt_rows_limbs(
        generator, random_key(generator), key_to, _reenc_plaintexts(key_from, basebit, t), alpha,
        zero_mask=_digit_zero_rows(params.n0, basebit, t, key_to.device),
    )
    return ProxyReencryptionKey(limbs, basebit, t, params)


def new_asymmetric(
    generator: torch.Generator | OsRandom, key_from: torch.Tensor, public_key_to: PublicKeyLv0,
    params: TfheParams, alpha: float | None = None, basebit: int | None = None, t: int | None = None,
) -> ProxyReencryptionKey:
    """The delegatee gives only a public key (reference
    proxy_reenc.rs:271-326)."""
    alpha, basebit, t = _decomposition(params, alpha, basebit, t)
    rows = public_key_to.encrypt_torus(generator, _reenc_plaintexts(key_from, basebit, t), alpha)
    rows[_digit_zero_rows(params.n0, basebit, t, rows.device)] = 0
    return ProxyReencryptionKey(planar_limbs(rows), basebit, t, params)


def reencrypt(ct: torch.Tensor, rk: ProxyReencryptionKey) -> torch.Tensor:
    """Re-encrypt lv0 LWE batches int32 [..., n0+1] from the source key to
    the target key (reference proxy_reenc.rs:468-509)."""
    n0 = rk.params.n0
    return digit_select_subtract(ct[..., :n0], ct[..., n0], rk.table_limbs, rk.t, rk.basebit, n0 + 1)


#: the reference's free-function name
reencrypt_tlwe_lv0 = reencrypt


def generate_keys_for_test(generator: torch.Generator | OsRandom, params: TfheParams):
    """(alice_sk, bob_sk, bob_pk) for examples and tests."""
    alice = SecretKey.generate(params, generator)
    bob = SecretKey.generate(params, generator)
    return alice, bob, PublicKeyLv0.generate(generator, bob.lv0, params)

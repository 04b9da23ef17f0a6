"""Secret and cloud (evaluation) keys as `nn.Module`s.

Reference: rs-tfhe key.rs. The key material lives in registered buffers, so
`ck.to("cuda")` moves a whole key to the card; the parameter set rides along
as a plain attribute. Generation draws from an explicit `torch.Generator` on
the device the key is made on.

Layouts:
  - `bsk`: the bootstrapping key as raw torus words, int32 [n0, 2L, 2, N] —
    the layout the blind-rotation kernel streams, and the JAX key's `bsk`
    bit for bit;
  - `ksk_limbs`: the key-switching key as balanced int8 limb planes,
    [N*t*base, 4*W] with W = n0+1 rounded up to a multiple of 8
    (`ksk_width`), the operand of the one-hot int8 product of
    ops/keyswitch.py. Rows with digit k = 0 are zero;
  - `bsk_mb` (optional, `CloudKey.generate(multibit=True)`): the multi-bit
    key as raw torus words, int32 [n0/2, 4, 2L, 2, N] — the layout the
    multi-bit kernel reads, and the JAX key's `bsk_mb` bit for bit. The
    JAX key's `bsk_mb_vecs` (an int8 limb layout for the TPU) has no
    counterpart.

`cloud_key_from_numpy` / `secret_key_from_numpy` build the port's keys from a
JAX key's arrays (as numpy), so the two packages can be held against each
other on the same key material.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .params import TORUS_BITS, TfheParams
from .tlwe import lwe_encrypt_torus
from .torus import (
    f64_to_torus,
    i32,
    recombine_planar,
    split_u32_limbs_planar,
    to_torch,
    wrap_i32,
)
from .trgsw import trgsw_encrypt_torus


class SecretKey(nn.Module):
    """Binary secret keys (reference key.rs:21-48): lv0 int32 [n0] and lv1
    int32 [N], values in {0, 1}."""

    def __init__(self, lv0: torch.Tensor, lv1: torch.Tensor, params: TfheParams):
        super().__init__()
        self.params = params
        self.register_buffer("lv0", lv0)
        self.register_buffer("lv1", lv1)

    @classmethod
    def generate(cls, params: TfheParams, generator: torch.Generator) -> "SecretKey":
        def bits(n):
            return torch.randint(
                0, 2, (n,), generator=generator, dtype=torch.int32,
                device=generator.device,
            )

        return cls(bits(params.n0), bits(params.n1), params)


class CloudKey(nn.Module):
    """Evaluation key bundle (reference key.rs:51-75): testvec int32 [2, N],
    bsk int32 [n0, 2L, 2, N], ksk_limbs int8 [N*t*base, 4*ksk_width] and,
    for a multi-bit key, bsk_mb int32 [n0/2, 4, 2L, 2, N] (else None)."""

    def __init__(
        self, testvec: torch.Tensor, bsk: torch.Tensor, ksk_limbs: torch.Tensor,
        params: TfheParams, bsk_mb: torch.Tensor | None = None,
    ):
        super().__init__()
        self.params = params
        self.register_buffer("testvec", testvec)
        self.register_buffer("bsk", bsk)
        self.register_buffer("ksk_limbs", ksk_limbs)
        self.register_buffer("bsk_mb", bsk_mb)

    @classmethod
    def generate(
        cls, sk: SecretKey, generator: torch.Generator, multibit: bool = False
    ) -> "CloudKey":
        """Key-switching then bootstrapping key, both drawn from `generator`
        (on the device the keys are made on, which must be sk's).

        multibit: also draw the multi-bit key (`gen_bootstrapping_key_mb`),
        after the other two, so the KSK and BSK are the same as those of a
        key generated with multibit=False from an equally seeded generator
        (as the JAX package keeps them, rs_tfhe_tpu/key.py:175-178).
        """
        ksk = gen_key_switching_key(generator, sk)
        bsk = gen_bootstrapping_key(generator, sk)
        mb = gen_bootstrapping_key_mb(generator, sk) if multibit else None
        return cls(gen_testvec(sk.params, sk.lv1.device), bsk, ksk, sk.params, mb)


def gen_testvec(params: TfheParams, device=None) -> torch.Tensor:
    """Constant test vector: a = 0, b[i] = 1/8 (reference key.rs:91-100)."""
    tv = torch.zeros((2, params.n1), dtype=torch.int32, device=device)
    tv[1] = i32(int(f64_to_torus(0.125)))
    return tv


def ksk_width(params: TfheParams) -> int:
    """Columns per limb plane of `ksk_limbs`: n0+1 rounded up to a multiple
    of 8 (the int8 product's shape rule on the card)."""
    return -(-(params.n0 + 1) // 8) * 8


def ksk_limbs_from_rows(rows: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Key-switching rows int32 [K, n0+1] -> planar limbs int8 [K, 4*W]."""
    k, w = rows.shape
    if w != params.n0 + 1:
        raise ValueError(f"expected rows of width {params.n0 + 1}, got {w}")
    padded = torch.nn.functional.pad(rows, (0, ksk_width(params) - w))
    return split_u32_limbs_planar(padded).reshape(k, -1)


def gen_key_switching_key(generator: torch.Generator, sk: SecretKey) -> torch.Tensor:
    """KSK rows encrypt k * s1[i] / 2^((j+1)*basebit) under s0.

    Reference: key.rs:102-122. The plaintexts are the exact integers
    (k*s1[i]) << (32 - (j+1)*basebit); rows with k = 0 are zeroed (the
    reference never writes them), so selecting digit k = 0 subtracts nothing.
    Returns the planar limb table consumed by ops/keyswitch.py.
    """
    params = sk.params
    g = params.trgsw_lv1
    dev = sk.lv1.device
    base = params.ks_base
    ks = torch.arange(base, dtype=torch.int64, device=dev)
    shifts = torch.tensor(
        [TORUS_BITS - (j + 1) * g.basebit for j in range(g.iks_t)],
        dtype=torch.int64, device=dev,
    )
    mu = (ks[None, None, :] * sk.lv1.to(torch.int64)[:, None, None]) << shifts[None, :, None]
    rows = lwe_encrypt_torus(generator, sk.lv0, wrap_i32(mu.reshape(-1)), params.ksk_alpha)
    rows[torch.arange(rows.shape[0], device=dev) % base == 0] = 0
    return ksk_limbs_from_rows(rows, params)


def gen_bootstrapping_key(generator: torch.Generator, sk: SecretKey) -> torch.Tensor:
    """TRGSW-encrypt each bit of s0 under s1 (reference key.rs:124-156).

    If the parameter set rounds the BSK (params.bsk_round_bits), the rows are
    reduced-modulus samples: mask on the 2^rb grid, body rounded to it (grid
    sampling, not post-hoc rounding, which would multiply the rounding error
    by the secret).
    """
    params = sk.params
    return trgsw_encrypt_torus(
        generator, sk.lv1, sk.lv0, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits,
    )


def gen_bootstrapping_key_mb(generator: torch.Generator, sk: SecretKey) -> torch.Tensor:
    """Multi-bit (grouping factor 2) bootstrapping key
    (rs_tfhe_tpu/key.py:243-280).

    For each pair of lv0 key bits (s1, s2) = (s[2i], s[2i+1]), TRGSW-encrypt
    the four pair indicators under s_lv1, in pattern order
    [(0,0), (1,0), (0,1), (1,1)]:

        (1-s1)(1-s2),  s1(1-s2),  (1-s1)s2,  s1*s2

    so that sum_v X^(a1*v1 + a2*v2) * ind_v = X^(a1*s1 + a2*s2) and one
    external product advances the rotation by two mask elements
    (ops/blind_rotate.blind_rotate_mb_plain). On the BSK's grid
    (params.bsk_round_bits). Returns int32 [n0/2, 4, 2L, 2, N].
    """
    params = sk.params
    if params.n0 % 2:
        raise ValueError(f"multi-bit grouping needs an even n0, got {params.n0}")
    s1, s2 = sk.lv0[0::2], sk.lv0[1::2]
    inds = torch.stack([(1 - s1) * (1 - s2), s1 * (1 - s2), (1 - s1) * s2, s1 * s2], dim=1)
    return trgsw_encrypt_torus(
        generator, sk.lv1, inds, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits,
    )


# ---------------------------------------------------------------------------
# Key material from the JAX package's keys
# ---------------------------------------------------------------------------

def secret_key_from_numpy(arrays, params: TfheParams, device=None) -> SecretKey:
    """`arrays["lv0"]`, `arrays["lv1"]`: the JAX SecretKey's uint32 vectors."""
    return SecretKey(
        to_torch(arrays["lv0"], device), to_torch(arrays["lv1"], device), params
    )


def cloud_key_from_numpy(arrays, params: TfheParams, device=None) -> CloudKey:
    """Build a CloudKey from a JAX CloudKey's arrays as numpy.

    arrays: `testvec` uint32 [2, N], `bsk` uint32 [n0, 2L, 2, N] and
    `ksk_limbs` int8 [K, 4*P], the JAX planar-padded limb table
    (`rs_tfhe_tpu.tlwe.lwe_encrypt_rows_limbs`, P = n0+1 padded to 128 lanes).
    The limb planes are recombined to the rows' torus words, the lane padding
    is stripped, and the rows are re-split into the port's layout. A
    multi-bit key's `bsk_mb` uint32 [n0/2, 4, 2L, 2, N] is taken as it is
    when `arrays` has it (and is not None).
    """
    g = params.trgsw_lv1
    k_rows = params.n1 * g.iks_t * params.ks_base
    kl = np.array(arrays["ksk_limbs"])
    if kl.dtype != np.int8 or kl.ndim != 2 or kl.shape[0] != k_rows or kl.shape[1] % 4:
        raise ValueError(f"ksk_limbs: expected int8 [{k_rows}, 4*P], got {kl.dtype} {kl.shape}")
    p = kl.shape[1] // 4
    words = recombine_planar(torch.from_numpy(kl).reshape(k_rows, 4, p))
    rows = words[:, : params.n0 + 1]
    bsk = to_torch(arrays["bsk"])
    expect = (params.n0, 2 * g.l, 2, params.n1)
    if tuple(bsk.shape) != expect:
        raise ValueError(f"bsk: expected shape {expect}, got {tuple(bsk.shape)}")
    bsk_mb = arrays["bsk_mb"] if "bsk_mb" in arrays else None
    if bsk_mb is not None:
        bsk_mb = to_torch(bsk_mb)
        expect_mb = (params.n0 // 2, 4, 2 * g.l, 2, params.n1)
        if tuple(bsk_mb.shape) != expect_mb:
            raise ValueError(f"bsk_mb: expected shape {expect_mb}, got {tuple(bsk_mb.shape)}")
    return CloudKey(
        to_torch(arrays["testvec"]), bsk, ksk_limbs_from_rows(rows, params), params, bsk_mb
    ).to(device)

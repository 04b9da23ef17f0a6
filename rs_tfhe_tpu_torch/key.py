"""Secret and cloud (evaluation) keys as `nn.Module`s.

Reference: rs-tfhe key.rs. The key material lives in registered buffers, so
`ck.to("cuda")` moves a whole key to the card; the parameter set rides along
as a plain attribute. Generation draws from an explicit `torch.Generator` on
the device the key is made on, or, in `generate_secure`, from the operating
system's CSPRNG (`torus.OsRandom`).

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

Masks and noise: every mask word of a generated cloud key is a public
threefry stream of the key's `gen_seed` on the JAX package's split tree
(`CloudKey.generate`), so from one `gen_seed` the port and the JAX package
make the same masks, and bodies that differ only by noise. The noise comes
from the caller's generator (or the operating system's CSPRNG), never from
`gen_seed`: a seeded key file (utils/serialization.save_cloud_key) holds
`gen_seed` and the bodies and nothing that replays a noise word. The JAX
package draws masks and noise from the one key it records, so its seeded
files publish the seed of their noise; the port keeps the file format and
the mask streams and not that.

`cloud_key_from_numpy` / `secret_key_from_numpy` build the port's keys from a
JAX key's arrays (as numpy), so the two packages can be held against each
other on the same key material.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .params import TORUS_BITS, TfheParams
from .tlwe import lwe_encrypt_rows_limbs
from .torus import (
    OsRandom,
    f64_to_torus,
    fold_in,
    i32,
    key_tensor,
    limb_width,
    planar_limbs,
    random_bits,
    random_key,
    resolve_device,
    rows_from_planar_limbs,
    split,
    to_torch,
    uniform_bits,
    wrap_i32,
)
from .trgsw import trgsw_encrypt_torus

#: fold_in data of the multi-bit key's branch of the split tree ("mb";
#: rs_tfhe_tpu/key.py:175-178)
MB_FOLD = 0x6D62


class SecretKey(nn.Module):
    """Binary secret keys (reference key.rs:21-48): lv0 int32 [n0] and lv1
    int32 [N], values in {0, 1}."""

    def __init__(self, lv0: torch.Tensor, lv1: torch.Tensor, params: TfheParams):
        super().__init__()
        self.params = params
        self.register_buffer("lv0", lv0)
        self.register_buffer("lv1", lv1)

    @classmethod
    def generate(cls, params: TfheParams, generator: torch.Generator | OsRandom) -> "SecretKey":
        return cls(uniform_bits(generator, params.n0), uniform_bits(generator, params.n1), params)

    @classmethod
    def generate_secure(cls, params: TfheParams, device=None) -> "SecretKey":
        """The production path (rs_tfhe_tpu/key.py:62-68): every key bit from
        the operating system's CSPRNG (`torus.OsRandom`), on `device` (None:
        the card). The JAX package seeds a threefry key with 64 bits of
        `os.urandom`; here every word is drawn from it, so no key rests on a
        64-bit seed. `generate` with a seeded generator stays the test path."""
        return cls.generate(params, OsRandom(device))


class CloudKey(nn.Module):
    """Evaluation key bundle (reference key.rs:51-75): testvec int32 [2, N],
    bsk int32 [n0, 2L, 2, N], ksk_limbs int8 [N*t*base, 4*ksk_width], for a
    multi-bit key bsk_mb int32 [n0/2, 4, 2L, 2, N] (else None), and for a
    generated key gen_seed int32 [2], the JAX uint32 key data its masks were
    drawn from (else None)."""

    def __init__(
        self, testvec: torch.Tensor, bsk: torch.Tensor, ksk_limbs: torch.Tensor,
        params: TfheParams, bsk_mb: torch.Tensor | None = None,
        gen_seed: torch.Tensor | None = None,
    ):
        super().__init__()
        self.params = params
        self.register_buffer("testvec", testvec)
        self.register_buffer("bsk", bsk)
        self.register_buffer("ksk_limbs", ksk_limbs)
        self.register_buffer("bsk_mb", bsk_mb)
        self.register_buffer("gen_seed", gen_seed)

    @classmethod
    def generate(
        cls, sk: SecretKey, generator: torch.Generator | OsRandom, multibit: bool = False,
        gen_seed=None,
    ) -> "CloudKey":
        """Key-switching, bootstrapping and (multibit=True) multi-bit keys on
        sk's device.

        Masks come from `gen_seed` (two words; None draws them from
        `generator`), on the JAX package's split tree
        (rs_tfhe_tpu/utils/serialization.py:125-169):

            k_ksk, k_bsk = split(gen_seed)
            KSK masks: the stream of split(k_ksk)[0], the k = 0 rows zero
            BSK masks: random_bits(split(k_bsk)[0], [n0, 2L, N]), on the grid
            bsk_mb masks: random_bits(split(fold_in(gen_seed, MB_FOLD))[0],
                          [n0/2, 4, 2L, N]), on the grid

        with the gadget constants on mask coefficient 0 of the first L rows.
        The noise comes from `generator` alone, KSK then BSK then multi-bit,
        so keys from equally seeded generators share their KSK and BSK with
        or without multibit (as rs_tfhe_tpu/key.py:175-178 keeps them).
        """
        gen_seed = random_key(generator) if gen_seed is None else key_tensor(gen_seed)
        k_ksk, k_bsk = split(gen_seed)
        ksk = gen_key_switching_key(generator, sk, split(k_ksk)[0])
        bsk = gen_bootstrapping_key(generator, sk, split(k_bsk)[0])
        mb = (gen_bootstrapping_key_mb(generator, sk, split(fold_in(gen_seed, MB_FOLD))[0])
              if multibit else None)
        dev = sk.lv1.device
        return cls(gen_testvec(sk.params, dev), bsk, ksk, sk.params, mb, gen_seed.to(dev))

    @classmethod
    def generate_secure(cls, sk: SecretKey, multibit: bool = False) -> "CloudKey":
        """Cloud-key generation with every noise word and `gen_seed` from the
        operating system's CSPRNG (`torus.OsRandom`), on sk's device: the
        companion of `SecretKey.generate_secure` (rs_tfhe_tpu/key.py:130-134).
        `gen_seed` seeds public masks only."""
        return cls.generate(sk, OsRandom(sk.lv1.device), multibit=multibit)

    @classmethod
    def generate_no_ksk(cls, params: TfheParams, device=None) -> "CloudKey":
        """All-zero keys beside the real test vector, for unit tests of the
        decomposition, external product and CMUX that skip keygen (reference
        new_no_ksk, key.rs:68-75; rs_tfhe_tpu/key.py:137-150), in the port's
        own layouts, on `device` (None: the card)."""
        device = resolve_device(device)
        g = params.trgsw_lv1
        ksk = torch.zeros(
            (params.n1 * g.iks_t * params.ks_base, 4 * ksk_width(params)), dtype=torch.int8, device=device
        )
        bsk = torch.zeros((params.n0, 2 * g.l, 2, params.n1), dtype=torch.int32, device=device)
        return cls(gen_testvec(params, device), bsk, ksk, params)


def gen_testvec(params: TfheParams, device=None) -> torch.Tensor:
    """Constant test vector: a = 0, b[i] = 1/8 (reference key.rs:91-100), on
    `device` (None: the card, torus.resolve_device)."""
    tv = torch.zeros((2, params.n1), dtype=torch.int32, device=resolve_device(device))
    tv[1] = i32(int(f64_to_torus(0.125)))
    return tv


def ksk_width(params: TfheParams) -> int:
    """Columns per limb plane of `ksk_limbs`: n0+1 rounded up to a multiple
    of 8 (the int8 product's shape rule on the card)."""
    return limb_width(params.n0 + 1)


def ksk_limbs_from_rows(rows: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """Key-switching rows int32 [K, n0+1] -> planar limbs int8 [K, 4*W]."""
    if rows.shape[1] != params.n0 + 1:
        raise ValueError(f"expected rows of width {params.n0 + 1}, got {rows.shape[1]}")
    return planar_limbs(rows)


def ksk_zero_rows(params: TfheParams, device=None) -> torch.Tensor:
    """bool [N*t*base]: the key-switching rows of digit k = 0, which are zero."""
    k = params.n1 * params.trgsw_lv1.iks_t * params.ks_base
    return torch.arange(k, device=resolve_device(device)) % params.ks_base == 0


def gen_key_switching_key(generator: torch.Generator, sk: SecretKey, mask_key=None) -> torch.Tensor:
    """KSK rows encrypt k * s1[i] / 2^((j+1)*basebit) under s0.

    Reference: key.rs:102-122. The plaintexts are the exact integers
    (k*s1[i]) << (32 - (j+1)*basebit); rows with k = 0 are zeroed (the
    reference never writes them), so selecting digit k = 0 subtracts nothing.
    The masks are the threefry stream of `mask_key` (None: a key drawn from
    `generator`), the noise comes from `generator`. Returns the planar limb
    table consumed by ops/keyswitch.py.
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
    mask_key = random_key(generator) if mask_key is None else mask_key
    return lwe_encrypt_rows_limbs(
        generator, mask_key, sk.lv0, wrap_i32(mu.reshape(-1)), params.ksk_alpha,
        zero_mask=ksk_zero_rows(params, dev),
    )


def gen_bootstrapping_key(generator: torch.Generator, sk: SecretKey, mask_key=None) -> torch.Tensor:
    """TRGSW-encrypt each bit of s0 under s1 (reference key.rs:124-156).

    The masks are `random_bits(mask_key, [n0, 2L, N])` (mask_key None: a
    key drawn from `generator`), the noise comes from `generator`. If the
    parameter set rounds the BSK (params.bsk_round_bits), the rows are
    reduced-modulus samples: mask on the 2^rb grid, body rounded to it (grid
    sampling, not post-hoc rounding, which would multiply the rounding error
    by the secret).
    """
    params = sk.params
    mask_key = random_key(generator) if mask_key is None else mask_key
    mask = random_bits(mask_key, (params.n0, 2 * params.trgsw_lv1.l, params.n1), sk.lv1.device)
    return trgsw_encrypt_torus(
        generator, sk.lv1, sk.lv0, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits, mask=mask,
    )


def gen_bootstrapping_key_mb(generator: torch.Generator, sk: SecretKey, mask_key=None) -> torch.Tensor:
    """Multi-bit (grouping factor 2) bootstrapping key
    (rs_tfhe_tpu/key.py:243-280).

    For each pair of lv0 key bits (s1, s2) = (s[2i], s[2i+1]), TRGSW-encrypt
    the four pair indicators under s_lv1, in pattern order
    [(0,0), (1,0), (0,1), (1,1)]:

        (1-s1)(1-s2),  s1(1-s2),  (1-s1)s2,  s1*s2

    so that sum_v X^(a1*v1 + a2*v2) * ind_v = X^(a1*s1 + a2*s2) and one
    external product advances the rotation by two mask elements
    (ops/blind_rotate.blind_rotate_mb_plain). On the BSK's grid
    (params.bsk_round_bits); masks `random_bits(mask_key, [n0/2, 4, 2L, N])`
    (mask_key None: a key drawn from `generator`), noise from `generator`.
    Returns int32 [n0/2, 4, 2L, 2, N].
    """
    params = sk.params
    if params.n0 % 2:
        raise ValueError(f"multi-bit grouping needs an even n0, got {params.n0}")
    s1, s2 = sk.lv0[0::2], sk.lv0[1::2]
    inds = torch.stack([(1 - s1) * (1 - s2), s1 * (1 - s2), (1 - s1) * s2, s1 * s2], dim=1)
    mask_key = random_key(generator) if mask_key is None else mask_key
    mask = random_bits(mask_key, (params.n0 // 2, 4, 2 * params.trgsw_lv1.l, params.n1), sk.lv1.device)
    return trgsw_encrypt_torus(
        generator, sk.lv1, inds, params.bsk_alpha, params,
        mask_grid_bits=params.bsk_round_bits, mask=mask,
    )


def round_bsk(bsk: torch.Tensor, round_bits: int) -> torch.Tensor:
    """Round every BSK coefficient to 32 - round_bits torus bits, to nearest,
    wrapping (rs_tfhe_tpu/key.py:283-295). A test helper for the rotation's
    dropped limbs: key generation samples on the grid instead."""
    if round_bits <= 0:
        return bsk
    return (bsk + (1 << (round_bits - 1))) & ~((1 << round_bits) - 1)


# ---------------------------------------------------------------------------
# Key material from the JAX package's keys
# ---------------------------------------------------------------------------

def secret_key_from_numpy(arrays, params: TfheParams, device=None) -> SecretKey:
    """`arrays["lv0"]`, `arrays["lv1"]`: the JAX SecretKey's uint32 vectors,
    onto `device` (None: the card, torus.resolve_device)."""
    device = resolve_device(device)
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
    multi-bit key's `bsk_mb` uint32 [n0/2, 4, 2L, 2, N] and a generated
    key's `gen_seed` uint32 [2] are taken as they are when `arrays` has them
    (and they are not None). The key is assembled on the host and moved to
    `device` (None: the card, torus.resolve_device).
    """
    device = resolve_device(device)
    g = params.trgsw_lv1
    k_rows = params.n1 * g.iks_t * params.ks_base
    kl = np.array(arrays["ksk_limbs"])
    if kl.dtype != np.int8 or kl.ndim != 2 or kl.shape[0] != k_rows or kl.shape[1] % 4:
        raise ValueError(f"ksk_limbs: expected int8 [{k_rows}, 4*P], got {kl.dtype} {kl.shape}")
    rows = rows_from_planar_limbs(torch.from_numpy(kl), params.n0 + 1)
    bsk = to_torch(arrays["bsk"], "cpu")
    expect = (params.n0, 2 * g.l, 2, params.n1)
    if tuple(bsk.shape) != expect:
        raise ValueError(f"bsk: expected shape {expect}, got {tuple(bsk.shape)}")
    bsk_mb = arrays["bsk_mb"] if "bsk_mb" in arrays else None
    if bsk_mb is not None:
        bsk_mb = to_torch(bsk_mb, "cpu")
        expect_mb = (params.n0 // 2, 4, 2 * g.l, 2, params.n1)
        if tuple(bsk_mb.shape) != expect_mb:
            raise ValueError(f"bsk_mb: expected shape {expect_mb}, got {tuple(bsk_mb.shape)}")
    gen_seed = arrays["gen_seed"] if "gen_seed" in arrays else None
    if gen_seed is not None:
        gen_seed = key_tensor(np.asarray(gen_seed, dtype=np.uint32))
    return CloudKey(
        to_torch(arrays["testvec"], "cpu"), bsk, ksk_limbs_from_rows(rows, params), params, bsk_mb, gen_seed
    ).to(device)

"""TFHE security parameters as runtime configuration.

A standalone copy of `rs_tfhe_tpu.params` (the port never imports the JAX
package): the same frozen dataclasses, the same fourteen reference sets plus
`TEST_TINY`, and the same derived quantities, so that every field can be held
equal to the reference in the tests. Values are transcribed from rs-tfhe
`src/params.rs:91-404`.

The torus is Z/2^32; the port carries it as two's-complement `torch.int32`.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

TORUS_BITS = 32  # reference: params.rs:44 (Torus = u32)


@dataclasses.dataclass(frozen=True)
class TlweParams:
    n: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class TrlweParams:
    n: int
    alpha: float


@dataclasses.dataclass(frozen=True)
class TrgswParams:
    n: int
    nbit: int
    bgbit: int
    l: int
    basebit: int
    iks_t: int
    alpha: float

    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """One complete TFHE parameter set (reference: SecurityParams, params.rs:53-60)."""

    security_bits: int
    description: str
    tlwe_lv0: TlweParams
    tlwe_lv1: TlweParams
    trlwe_lv1: TrlweParams
    trgsw_lv1: TrgswParams
    #: Generate the bootstrapping key on the 2^bsk_round_bits grid of the
    #: torus (trlwe.trlwe_encrypt_torus mask_grid_bits): a reduced-modulus
    #: key whose low bits are zero. The rounding error is uniform noise
    #: ~2^-(32-rb), accounted for in the reference's noise model.
    bsk_round_bits: int = 0

    # ---- derived quantities used throughout the pipeline ----

    @property
    def n0(self) -> int:
        """LWE lv0 dimension (mask length)."""
        return self.tlwe_lv0.n

    @property
    def n1(self) -> int:
        """LWE lv1 / ring dimension N."""
        return self.trlwe_lv1.n

    @property
    def ks_base(self) -> int:
        return 1 << self.trgsw_lv1.basebit

    @property
    def ksk_alpha(self) -> float:
        # reference: params.rs:468 (KSK_ALPHA = tlwe_lv0.alpha)
        return self.tlwe_lv0.alpha

    @property
    def bsk_alpha(self) -> float:
        # reference: params.rs:469 (BSK_ALPHA = tlwe_lv1.alpha)
        return self.tlwe_lv1.alpha

    @cached_property
    def decomposition_offset(self) -> int:
        """Gadget-decomposition rounding offset (reference: key.rs:78-89).

        offset = sum_i  Bg/2 * 2^(32 - (i+1)*bgbit)  (mod 2^32)
        """
        g = self.trgsw_lv1
        off = 0
        for i in range(g.l):
            off = (off + g.half_bg * (1 << (TORUS_BITS - (i + 1) * g.bgbit))) % (
                1 << TORUS_BITS
            )
        return off

    @property
    def decomposition_round_bit(self) -> int:
        """Rounding half-step 2^(32 - L*bgbit - 1) added before gadget
        decomposition so the dropped low bits round to nearest instead of
        truncating (the centered decomposition; the reference, trgsw.rs:144-171,
        truncates, and its biased error dominates blind-rotation noise)."""
        g = self.trgsw_lv1
        kept = g.l * g.bgbit
        return (1 << (TORUS_BITS - kept - 1)) if kept < TORUS_BITS else 0

    @property
    def digit_limbs(self) -> int:
        """Number of balanced signed 8-bit limbs needed for one gadget digit.

        Digits lie in [-Bg/2, Bg/2): for bgbit <= 8 they are int8-exact. For
        larger Bg the residual limb of a k-limb balanced base-256 split has
        magnitude <= (Bg/2 >> 8(k-1)) + 1 (carry) and must fit int8. The
        port's arithmetic does not split digits into limbs; the property is
        kept so the parameter sets compare field for field.
        """
        half = 1 << (self.trgsw_lv1.bgbit - 1)
        if half <= 128:
            return 1
        k = 2
        while (half >> (8 * (k - 1))) + 1 > 127:
            k += 1
        return k


# ---------------------------------------------------------------------------
# Reference parameter sets (values transcribed from rs-tfhe params.rs:91-404)
# ---------------------------------------------------------------------------

SECURITY_80_BIT = TfheParams(
    security_bits=80,
    description="80-bit security (performance-optimized)",
    tlwe_lv0=TlweParams(n=550, alpha=5.0e-5),
    tlwe_lv1=TlweParams(n=1024, alpha=3.73e-8),
    trlwe_lv1=TrlweParams(n=1024, alpha=3.73e-8),
    trgsw_lv1=TrgswParams(n=1024, nbit=10, bgbit=6, l=3, basebit=2, iks_t=7, alpha=3.73e-8),
)

SECURITY_110_BIT = TfheParams(
    security_bits=110,
    description="110-bit security (balanced, original TFHE)",
    tlwe_lv0=TlweParams(n=630, alpha=3.0517578125e-05),
    tlwe_lv1=TlweParams(n=1024, alpha=2.9802322387695313e-8),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.9802322387695313e-8),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=6, l=3, basebit=2, iks_t=8, alpha=2.9802322387695313e-8
    ),
)

SECURITY_128_BIT = TfheParams(
    security_bits=128,
    description="128-bit security (high security, quantum-resistant)",
    tlwe_lv0=TlweParams(n=700, alpha=2.0e-5),
    tlwe_lv1=TlweParams(n=1024, alpha=2.0e-8),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.0e-8),
    trgsw_lv1=TrgswParams(n=1024, nbit=10, bgbit=6, l=3, basebit=2, iks_t=9, alpha=2.0e-8),
)

SECURITY_UINT1 = TfheParams(
    security_bits=1,
    description="Uint1 parameters (1-bit binary/boolean, messageModulus=2, N=1024)",
    tlwe_lv0=TlweParams(n=700, alpha=2.0e-05),
    tlwe_lv1=TlweParams(n=1024, alpha=2.0e-08),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.0e-08),
    trgsw_lv1=TrgswParams(n=1024, nbit=10, bgbit=10, l=2, basebit=2, iks_t=8, alpha=2.0e-08),
)

SECURITY_UINT2 = TfheParams(
    security_bits=2,
    description="Uint2 parameters (2-bit messages, messageModulus=4, N=1024)",
    tlwe_lv0=TlweParams(n=687, alpha=0.00002120846893069972),
    tlwe_lv1=TlweParams(n=1024, alpha=0.0000000000023184122752704995),
    trlwe_lv1=TrlweParams(n=1024, alpha=0.0000000000023184122752704995),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=18, l=1, basebit=4, iks_t=3,
        alpha=0.0000000000023184122752704995,
    ),
)

SECURITY_UINT3 = TfheParams(
    security_bits=3,
    description="Uint3 parameters (3-bit messages, messageModulus=8, N=1024)",
    tlwe_lv0=TlweParams(n=820, alpha=0.0000025167616095979554),
    tlwe_lv1=TlweParams(n=1024, alpha=0.0000000000000002220446049250313),
    trlwe_lv1=TrlweParams(n=1024, alpha=0.0000000000000002220446049250313),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=23, l=1, basebit=6, iks_t=2,
        alpha=0.0000000000000002220446049250313,
    ),
)

SECURITY_UINT4 = TfheParams(
    security_bits=4,
    description="Uint4 parameters (4-bit messages, messageModulus=16, N=1024)",
    tlwe_lv0=TlweParams(n=820, alpha=0.0000025167616095979554),
    tlwe_lv1=TlweParams(n=1024, alpha=0.0000000000000002220446049250313),
    trlwe_lv1=TrlweParams(n=1024, alpha=0.0000000000000002220446049250313),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=22, l=1, basebit=5, iks_t=3,
        alpha=0.0000000000000002220446049250313,
    ),
)

SECURITY_UINT5 = TfheParams(
    security_bits=5,
    description="Uint5 parameters (5-bit messages, messageModulus=32, N=1024)",
    tlwe_lv0=TlweParams(n=1071, alpha=7.08822676541043e-8),
    tlwe_lv1=TlweParams(n=1024, alpha=2.2204460492503131e-17),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.2204460492503131e-17),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=22, l=1, basebit=6, iks_t=3, alpha=2.2204460492503131e-17
    ),
)

SECURITY_UINT6 = TfheParams(
    security_bits=6,
    description="Uint6 parameters (6-bit messages, messageModulus=64, N=1024)",
    tlwe_lv0=TlweParams(n=1071, alpha=7.08822676541043e-8),
    tlwe_lv1=TlweParams(n=1024, alpha=2.2204460492503131e-17),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.2204460492503131e-17),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=22, l=1, basebit=6, iks_t=3, alpha=2.2204460492503131e-17
    ),
)

SECURITY_UINT7 = TfheParams(
    security_bits=7,
    description="Uint7 parameters (7-bit messages, messageModulus=128, N=1024)",
    tlwe_lv0=TlweParams(n=1160, alpha=1.9662200074984027e-8),
    tlwe_lv1=TlweParams(n=1024, alpha=2.2204460492503131e-17),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.2204460492503131e-17),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=22, l=1, basebit=7, iks_t=3, alpha=2.2204460492503131e-17
    ),
)

SECURITY_UINT8 = TfheParams(
    security_bits=8,
    description="Uint8 parameters (8-bit messages, messageModulus=256, N=1024)",
    tlwe_lv0=TlweParams(n=1160, alpha=1.9662200074984027e-8),
    tlwe_lv1=TlweParams(n=1024, alpha=2.2204460492503131e-17),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.2204460492503131e-17),
    trgsw_lv1=TrgswParams(
        n=1024, nbit=10, bgbit=22, l=1, basebit=7, iks_t=3, alpha=2.2204460492503131e-17
    ),
)

#: Same LWE hardness as SECURITY_128_BIT (identical n, alpha on both levels),
#: with a leaner gadget (L=2 rows of Bg=2^8, safe with the centered
#: decomposition) and the bootstrapping key generated on the 2^8 grid of the
#: torus (a 24-bit key).
SECURITY_128_BIT_FAST = TfheParams(
    security_bits=128,
    description="128-bit security, fast gadget (L=2, Bg=2^8, 24-bit BSK)",
    tlwe_lv0=TlweParams(n=700, alpha=2.0e-5),
    tlwe_lv1=TlweParams(n=1024, alpha=2.0e-8),
    trlwe_lv1=TrlweParams(n=1024, alpha=2.0e-8),
    trgsw_lv1=TrgswParams(n=1024, nbit=10, bgbit=8, l=2, basebit=2, iks_t=9, alpha=2.0e-8),
    bsk_round_bits=8,
)

#: N=2048 ring for multi-bit (LUT/radix) arithmetic; lv0 is the reference's
#: own Uint3/Uint4 pair (params.rs:210/239).
SECURITY_128_BIT_RADIX = TfheParams(
    security_bits=128,
    description="128-bit security, N=2048 ring for fast radix LUT arithmetic",
    tlwe_lv0=TlweParams(n=820, alpha=0.0000025167616095979554),
    tlwe_lv1=TlweParams(n=2048, alpha=1.0e-14),
    trlwe_lv1=TrlweParams(n=2048, alpha=1.0e-14),
    trgsw_lv1=TrgswParams(
        n=2048, nbit=11, bgbit=8, l=3, basebit=2, iks_t=12, alpha=1.0e-14
    ),
)

#: N=4096 ring for certified base-16 (nibble) LUTs; lv0 is the reference's
#: own Uint7/Uint8 pair (params.rs:229).
SECURITY_128_BIT_NIBBLE = TfheParams(
    security_bits=128,
    description="128-bit security, N=4096 ring: certified base-16 nibble LUTs",
    tlwe_lv0=TlweParams(n=1160, alpha=1.9662200074984027e-8),
    tlwe_lv1=TlweParams(n=4096, alpha=2.2204460492503131e-17),
    trlwe_lv1=TrlweParams(n=4096, alpha=2.2204460492503131e-17),
    trgsw_lv1=TrgswParams(
        n=4096, nbit=12, bgbit=8, l=3, basebit=2, iks_t=12,
        alpha=2.2204460492503131e-17,
    ),
)

DEFAULT_SECURITY = SECURITY_128_BIT

#: Small-but-functional set for fast unit tests. Noise rates are set so far
#: below the message spacing that decryption is effectively deterministic.
#: NOT secure; test-only.
TEST_TINY = TfheParams(
    security_bits=0,
    description="insecure tiny parameters for unit tests",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=64, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=64, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=64, nbit=6, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)

ALL_SECURITY_SETS = {
    "SECURITY_80_BIT": SECURITY_80_BIT,
    "SECURITY_110_BIT": SECURITY_110_BIT,
    "SECURITY_128_BIT": SECURITY_128_BIT,
    "SECURITY_128_BIT_FAST": SECURITY_128_BIT_FAST,
    "SECURITY_128_BIT_RADIX": SECURITY_128_BIT_RADIX,
    "SECURITY_128_BIT_NIBBLE": SECURITY_128_BIT_NIBBLE,
    "SECURITY_UINT1": SECURITY_UINT1,
    "SECURITY_UINT2": SECURITY_UINT2,
    "SECURITY_UINT3": SECURITY_UINT3,
    "SECURITY_UINT4": SECURITY_UINT4,
    "SECURITY_UINT5": SECURITY_UINT5,
    "SECURITY_UINT6": SECURITY_UINT6,
    "SECURITY_UINT7": SECURITY_UINT7,
    "SECURITY_UINT8": SECURITY_UINT8,
}


def security_info(params: TfheParams) -> str:
    """Reference: params.rs:414-419."""
    return f"Security level: {params.security_bits} bits ({params.description})"


def params_from(p) -> TfheParams:
    """This module's TfheParams for any parameter-set dataclass with the same
    fields, such as one of the JAX package's sets."""
    d = dataclasses.asdict(p)
    return TfheParams(
        security_bits=d["security_bits"],
        description=d["description"],
        tlwe_lv0=TlweParams(**d["tlwe_lv0"]),
        tlwe_lv1=TlweParams(**d["tlwe_lv1"]),
        trlwe_lv1=TrlweParams(**d["trlwe_lv1"]),
        trgsw_lv1=TrgswParams(**d["trgsw_lv1"]),
        bsk_round_bits=d["bsk_round_bits"],
    )

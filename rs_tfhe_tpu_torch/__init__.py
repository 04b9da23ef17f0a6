"""rs_tfhe_tpu_torch — the TFHE gate-bootstrapping framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of `rs_tfhe_tpu` (the JAX package, which stays the reference): the
same modules at the same relative paths, the same parameter sets, and the
same exact arithmetic mod 2^32, carried as two's-complement int32 tensors.
The blind rotations run in hand-written kernels (csrc/*.cu) on a CUDA tensor
and in plain PyTorch versions on a CPU tensor; everything else is plain
PyTorch, apart from the native C++ client (`native`, built with g++ from the
repository's csrc/ at first use). This package never imports JAX.
"""

__version__ = "0.4.0"

from .params import (  # noqa: F401
    ALL_SECURITY_SETS,
    DEFAULT_SECURITY,
    SECURITY_80_BIT,
    SECURITY_110_BIT,
    SECURITY_128_BIT,
    SECURITY_128_BIT_FAST,
    SECURITY_128_BIT_NIBBLE,
    SECURITY_128_BIT_RADIX,
    SECURITY_UINT1,
    SECURITY_UINT2,
    SECURITY_UINT3,
    SECURITY_UINT4,
    SECURITY_UINT5,
    SECURITY_UINT6,
    SECURITY_UINT7,
    SECURITY_UINT8,
    TEST_TINY,
    TfheParams,
    security_info,
)

from . import bit_utils, bootstrap, gates, lut, models, proxy_reenc, tlwe, trgsw, trlwe, utils  # noqa: F401,E402
from .bootstrap import LutBootstrap, VanillaBootstrap, default_bootstrap  # noqa: F401,E402
from .fhe import FheBool, FheInt, FheUint, FheUintRadix  # noqa: F401,E402
from .gates import Gates  # noqa: F401,E402
from .key import CloudKey, SecretKey  # noqa: F401,E402

"""Global backend configuration.

Environment override: RS_TFHE_STEP_IMPL (read once, at import, as
`rs_tfhe_tpu/config.py` does).

`step_impl` selects the blind-rotation route. The values the port has:
  - "auto"           — on a CUDA tensor the whole-rotation kernel
                       (csrc/blind_rotate.cu), or, when the key has `bsk_mb`
                       and the batch is at most
                       `ops.blind_rotate.mb_route_batch_cap` (2 at L=2, 4 at
                       L>=3, as in the JAX package), the multi-bit kernel
                       (csrc/blind_rotate_mb.cu); on a CPU tensor the plain
                       PyTorch versions of the same;
  - "fused_small_mb" — forces the multi-bit rotation at every batch, as in
                       the JAX package; a key without `bsk_mb` takes the
                       standard rotation, as under "auto";
  - "pallas"         — the per-step route: per CMUX step, rotate and
                       decompose in PyTorch, then one external-product kernel
                       launch (csrc/external_product.cu) on the card, the
                       plain product on the CPU;
  - "nussbaumer"     — the per-step route with the Nussbaumer transform
                       product (ops/nussbaumer.py): its pointwise s16 dots on
                       the probe dot's byte-limb unit (csrc/probes.cu) on the
                       card, their plain version on the CPU; raises where
                       `ops.nussbaumer.check_bounds` fails (the Uint, RADIX
                       and NIBBLE sets). "auto" never takes it (the JAX
                       package's auto takes it only on a TPU);
  - "xla"            — the plain PyTorch rotation
                       (`ops.blind_rotate.blind_rotate_plain`) on the
                       ciphertext's device, CPU or CUDA, as the JAX
                       package's "xla" forces its dot_general path on any
                       device. A multi-bit key does not change the route
                       (the JAX package's multi-bit branch is taken under
                       "fused_small_mb" and "auto" only). "auto" never
                       takes it.
The JAX package's other values ("fused", "fused_small", "fused_wide",
"fused_tile") select TPU schedules; they raise ValueError when a rotation
reads them.
"""

from __future__ import annotations

import dataclasses
import os

STEP_IMPLS = ("auto", "fused_small_mb", "pallas", "nussbaumer", "xla")
_NOT_PORTED = ("fused", "fused_small", "fused_wide", "fused_tile")


@dataclasses.dataclass
class Config:
    step_impl: str = os.environ.get("RS_TFHE_STEP_IMPL", "auto")


config = Config()


def step_impl() -> str:
    """The configured route, checked: raises ValueError for a value the port
    does not have."""
    impl = config.step_impl
    if impl in STEP_IMPLS:
        return impl
    if impl in _NOT_PORTED:
        raise ValueError(
            f"step_impl={impl!r} is a route of the JAX package that is not ported; "
            f"the port has {STEP_IMPLS}"
        )
    raise ValueError(f"unknown step_impl={impl!r}; the port has {STEP_IMPLS}")

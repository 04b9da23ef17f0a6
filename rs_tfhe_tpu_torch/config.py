"""Global backend configuration.

Environment override: RS_TFHE_STEP_IMPL (read once, at import, as
`rs_tfhe_tpu/config.py` does).

`step_impl` selects the blind-rotation route. The values the port has:
  - "auto"           — on a CUDA tensor the whole-rotation kernel
                       (csrc/blind_rotate.cu), or the multi-bit kernel
                       (csrc/blind_rotate_mb.cu), at every batch, when the
                       key has `bsk_mb`; on a CPU tensor the plain PyTorch
                       versions of the same;
  - "fused_small_mb" — the JAX package's name for forcing the multi-bit
                       rotation: routes as "auto" does, but raises if the
                       key has no `bsk_mb`;
  - "pallas"         — the per-step route: per CMUX step, rotate and
                       decompose in PyTorch, then one external-product kernel
                       launch (csrc/external_product.cu) on the card, the
                       plain product on the CPU.
The JAX package's other values ("xla", "nussbaumer", "fused", "fused_small",
"fused_wide", "fused_tile") select TPU schedules or modules not ported; they
raise ValueError when a rotation reads them.
"""

from __future__ import annotations

import dataclasses
import os

STEP_IMPLS = ("auto", "fused_small_mb", "pallas")
_NOT_PORTED = ("xla", "nussbaumer", "fused", "fused_small", "fused_wide", "fused_tile")


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

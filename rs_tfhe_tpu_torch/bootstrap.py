"""Gate bootstrapping: blind rotate -> sample extract -> key switch.

Mirrors the reference's strategy trait (bootstrap/mod.rs:23-43) for the
vanilla strategy. The programmable (LUT) strategy is not ported yet.
"""

from __future__ import annotations

import torch

from .key import CloudKey
from .ops.blind_rotate import blind_rotate
from .ops.extract import sample_extract
from .ops.keyswitch import identity_key_switch


def bootstrap_without_key_switch(ct: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Blind rotate + extract, staying at lv1: int32 [..., n0+1] (any leading
    batch shape) -> [..., N+1].

    As in the JAX package (and unlike the reference's vanilla.rs:54-63, which
    truncates the mask to n0 coefficients), the full lv1 LWE is returned so
    callers can combine linearly and key-switch once (see gates.mux).
    """
    lead = ct.shape[:-1]
    acc = blind_rotate(ct.reshape(-1, ct.shape[-1]), ck.testvec, ck.bsk, ck.params)
    lv1 = sample_extract(acc, 0)
    return lv1.reshape(*lead, lv1.shape[-1])


def bootstrap(ct: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Full gate bootstrap: int32 [..., n0+1] -> [..., n0+1]
    (reference vanilla.rs:40-52)."""
    return identity_key_switch(bootstrap_without_key_switch(ct, ck), ck.ksk_limbs, ck.params)


class VanillaBootstrap:
    """Standard TFHE bootstrapping (reference bootstrap/vanilla.rs)."""

    name = "vanilla"

    def bootstrap(self, ct, ck):
        return bootstrap(ct, ck)

    def bootstrap_gate(self, ct, ck):
        """Refresh a gate-linear-form ciphertext (+/-1/8 boolean encoding)."""
        return bootstrap(ct, ck)

    def bootstrap_without_key_switch(self, ct, ck):
        return bootstrap_without_key_switch(ct, ck)


def default_bootstrap() -> VanillaBootstrap:
    """Reference: bootstrap/mod.rs:41-43."""
    return VanillaBootstrap()

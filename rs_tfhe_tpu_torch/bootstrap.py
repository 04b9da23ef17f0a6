"""Bootstrap strategies: vanilla and programmable (LUT).

Mirrors the reference's strategy trait (bootstrap/mod.rs:23-43) and the JAX
package's rs_tfhe_tpu/bootstrap.py: blind rotate -> sample extract -> key
switch, with a caller-supplied test vector for programmable bootstrapping.
"""

from __future__ import annotations

import collections
import math

import torch

from .key import CloudKey
from .lut.generator import Generator
from .lut.lookup_table import LookupTable
from .ops.blind_rotate import blind_rotate
from .ops.extract import sample_extract
from .ops.keyswitch import identity_key_switch
from .utils.noise import mb_lut_route_ok
from .utils.profiling import span

#: Lookup tables `LutBootstrap.bootstrap_func` built in this process (its
#: cache's misses): one a (function, modulus, set, device) while the cache
#: holds it.
tables_built = 0

#: Programmable (LUT) bootstraps in this process: "calls" (each
#: `bootstrap_with_testvec` and `lut.multi_value_bootstrap` call),
#: "ciphertexts" (the ciphertexts they rotated) and "per_row_luts" (the calls
#: whose test vector is per ciphertext). The gate path counts none.
pbs_counts: collections.Counter = collections.Counter()


def pbs_span(ciphertexts: int, per_row: bool):
    """Count one programmable bootstrap of `ciphertexts` ciphertexts and
    return its span, `tfhe.pbs`, which encloses the call's rotation, extract
    and key switch spans."""
    pbs_counts["calls"] += 1
    pbs_counts["ciphertexts"] += ciphertexts
    pbs_counts["per_row_luts"] += per_row
    return span("tfhe.pbs")


def _rotate_extract(ct: torch.Tensor, testvec: torch.Tensor, ck: CloudKey, bsk_mb) -> torch.Tensor:
    """Blind rotate + extract over any leading batch shape:
    int32 [..., n0+1] -> [..., N+1]."""
    lead = ct.shape[:-1]
    acc = blind_rotate(ct.reshape(-1, ct.shape[-1]), testvec, ck.bsk, ck.params, bsk_mb=bsk_mb)
    lv1 = sample_extract(acc, 0)
    return lv1.reshape(*lead, lv1.shape[-1])


def bootstrap_without_key_switch(ct: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Blind rotate + extract, staying at lv1: int32 [..., n0+1] (any leading
    batch shape) -> [..., N+1].

    As in the JAX package (and unlike the reference's vanilla.rs:54-63, which
    truncates the mask to n0 coefficients), the full lv1 LWE is returned so
    callers can combine linearly and key-switch once (see gates.mux). A
    multi-bit key routes small batches through the multi-bit rotation, as
    rs_tfhe_tpu/bootstrap.py:48-50 does.
    """
    return _rotate_extract(ct, ck.testvec, ck, ck.bsk_mb)


def bootstrap(ct: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Full gate bootstrap: int32 [..., n0+1] -> [..., n0+1]
    (reference vanilla.rs:40-52; rs_tfhe_tpu/bootstrap.py:26-36)."""
    return identity_key_switch(bootstrap_without_key_switch(ct, ck), ck.ksk_limbs, ck.params)


def bootstrap_with_testvec(
    ct: torch.Tensor, testvec: torch.Tensor, ck: CloudKey, allow_mb: bool | None = None
) -> torch.Tensor:
    """Programmable bootstrap against a caller-supplied test vector.

    ct: int32 [..., n0+1]; testvec: int32 [2, N] (shared) or [..., 2, N]
    (per-ciphertext LUTs). Reference: trgsw.rs:242-274 + bootstrap/lut.rs:79-99.

    allow_mb: whether a multi-bit key may route small batches through the
    multi-bit rotation. None applies the noise policy
    `utils.noise.mb_lut_route_ok` (true where the route moves every LUT
    decision margin by < 1%: the RADIX and NIBBLE sets, not FAST or strict),
    as rs_tfhe_tpu/bootstrap.py:54-84 does.

    Runs inside the span `tfhe.pbs` and counts in `pbs_counts`.
    """
    if allow_mb is None:
        allow_mb = mb_lut_route_ok(ck.params)
    per_row = testvec.dim() > 2
    with pbs_span(math.prod(ct.shape[:-1]), per_row):
        if per_row:
            # per-ciphertext test vectors may come broadcast (expand); the
            # kernel reads them densely, as JAX's reshape of a broadcast
            # array does
            testvec = testvec.reshape(-1, *testvec.shape[-2:]).contiguous()
        lv1 = _rotate_extract(ct, testvec, ck, ck.bsk_mb if allow_mb else None)
        return identity_key_switch(lv1, ck.ksk_limbs, ck.params)


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


class LutBootstrap:
    """Programmable bootstrapping strategy (reference bootstrap/lut.rs;
    rs_tfhe_tpu/bootstrap.py:103-164).

    Repeated (f, modulus, params) calls hit a bounded per-strategy LUT cache,
    so steady-state pipelines build each table once; the table is kept on the
    key's device. Pass a stable function object (not a fresh lambda per call)
    to benefit; `bootstrap_lut` with a prebuilt LookupTable is the explicit
    route."""

    name = "lut"

    #: Bounded so caches keyed by fresh lambdas cannot grow without limit.
    _LUT_CACHE_MAX = 64

    def __init__(self):
        self._lut_cache: dict = {}

    def bootstrap_func(self, ct, f, message_modulus: int, ck: CloudKey):
        global tables_built
        key = (f, message_modulus, ck.params, ck.testvec.device)
        lut = self._lut_cache.get(key)
        if lut is None:
            tables_built += 1
            poly = Generator(message_modulus, ck.params).generate_lookup_table(f).poly
            lut = LookupTable(poly.to(ck.testvec.device))
            if len(self._lut_cache) >= self._LUT_CACHE_MAX:
                self._lut_cache.pop(next(iter(self._lut_cache)))
            self._lut_cache[key] = lut
        return self.bootstrap_lut(ct, lut, ck)

    def bootstrap_lut(self, ct, lut, ck: CloudKey):
        return bootstrap_with_testvec(ct, lut.poly, ck)

    def bootstrap(self, ct, ck):
        """Identity over the mod-2 message encoding m/(2*modulus) (reference
        lut.rs:109-112). Not valid for gate linear forms; see bootstrap_gate."""
        return self.bootstrap_func(ct, _identity, 2, ck)

    def bootstrap_gate(self, ct, ck):
        """Refresh a gate-linear-form ciphertext (+/-1/8 boolean encoding)
        through the sign test vector, with allow_mb=True as the vanilla path
        (the JAX package's deviation from the reference's identity-mod-2 LUT,
        whose range boundaries the gate phases land on)."""
        return bootstrap_with_testvec(ct, ck.testvec, ck, allow_mb=True)

    def bootstrap_without_key_switch(self, ct, ck):
        """Same lv1 output contract as VanillaBootstrap."""
        return bootstrap_without_key_switch(ct, ck)


def _identity(x):
    return x


def default_bootstrap() -> VanillaBootstrap:
    """Reference: bootstrap/mod.rs:41-43."""
    return VanillaBootstrap()

"""The typed FHE API: encrypted booleans and integers with Python operator
overloading, as rs_tfhe_tpu/fhe.py computes it, bit for bit.

`FheBool`, `FheUint`/`FheInt` (bit level, boolean circuits) and
`FheUintRadix` (digit level, programmable-bootstrap arithmetic) wrap the
batch-first ciphertext tensors, so that `x * y + 3` is encrypted code. One
object holds a whole batch: every operator runs every element, and every bit
or digit position, through single batched bootstraps on the ciphertexts'
device.

Plaintext operands (Python ints and bools, numpy arrays) become trivial
(noiseless, maskless) ciphertexts on the cloud key's device, so `a & True`
and `x + 7` work; the result is still a real ciphertext. Client-side
`encrypt` takes a `torch.Generator` (or `torus.OsRandom`), as the port's
`tlwe` functions do, and `decrypt` returns numpy arrays. The seeded
constructors of the JAX API (`encrypt_seeded`, `expand_seeded`) wait for the
port's threefry.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gates
from .key import CloudKey
from .models import arithmetic, circuits
from .tlwe import lwe_decrypt_bool, lwe_encrypt_bool, lwe_trivial_bool, lwe_trivial_message


def _bits_of(vals, width: int) -> np.ndarray:
    """LSB-first bit planes of an integer array: [..., width] bool."""
    vals = np.asarray(vals).astype(np.int64).astype(np.uint64)  # wrap negatives
    return np.stack([(vals >> np.uint64(i)) & np.uint64(1) for i in range(width)], axis=-1).astype(bool)


def _device(ck: CloudKey) -> torch.device:
    return ck.testvec.device


class FheBool:
    """A (batch of) encrypted boolean(s): int32 [..., n0+1] and the cloud key.

    `&`, `|`, `^` are single batched gate bootstraps, `~` the free NOT,
    `select` the bootstrapped MUX. Plain bools and arrays on either side are
    coerced to trivial ciphertexts.
    """

    __slots__ = ("ct", "ck")

    def __init__(self, ct: torch.Tensor, ck: CloudKey):
        self.ct = ct
        self.ck = ck

    # -- client side ------------------------------------------------------
    @classmethod
    def encrypt(cls, generator, sk_lv0: torch.Tensor, values, ck: CloudKey) -> "FheBool":
        """Encrypt a bool or an array of bools under the lv0 secret key."""
        return cls(lwe_encrypt_bool(generator, sk_lv0, np.asarray(values, dtype=bool), ck.params.tlwe_lv0.alpha), ck)

    @classmethod
    def trivial(cls, values, ck: CloudKey) -> "FheBool":
        """Plaintext bools as noiseless ciphertexts (server side), on the key's device."""
        return cls(lwe_trivial_bool(values, ck.params.tlwe_lv0.n, _device(ck)), ck)

    def decrypt(self, sk_lv0: torch.Tensor) -> np.ndarray:
        return lwe_decrypt_bool(self.ct, sk_lv0).cpu().numpy()

    # -- server side ------------------------------------------------------
    def _coerce(self, other) -> "FheBool":
        if isinstance(other, FheBool):
            return other
        return FheBool.trivial(np.broadcast_to(np.asarray(other, dtype=bool), self.ct.shape[:-1]).copy(), self.ck)

    def __and__(self, other):
        return FheBool(gates.and_(self.ct, self._coerce(other).ct, self.ck), self.ck)

    def __or__(self, other):
        return FheBool(gates.or_(self.ct, self._coerce(other).ct, self.ck), self.ck)

    def __xor__(self, other):
        return FheBool(gates.xor(self.ct, self._coerce(other).ct, self.ck), self.ck)

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return FheBool(gates.not_(self.ct), self.ck)

    def select(self, if_true, if_false):
        """Bootstrapped MUX: self ? if_true : if_false, element-wise, over
        FheBool, FheUint and FheUintRadix branches (the selector broadcasts
        over the bit or digit axis; FheUintRadix takes the 3-rotation
        arithmetic.select_radix)."""
        if isinstance(if_true, FheUintRadix):
            return FheUintRadix(
                arithmetic.select_radix(self.ct, if_true.digits, if_false.digits, self.ck, if_true.base_bits),
                if_true.base_bits, self.ck, if_true.multi_value,
            )
        if isinstance(if_true, FheUint):
            sel = self.ct[..., None, :].expand(if_true.bits.shape)
            return type(if_true)(gates.mux(sel, if_true.bits, if_false.bits, self.ck), self.ck)
        t, f = self._coerce(if_true), self._coerce(if_false)
        return FheBool(gates.mux(self.ct, t.ct, f.ct, self.ck), self.ck)

    __hash__ = None  # comparisons returning FheBool live on the integer types

    def __repr__(self):
        return f"FheBool(batch={tuple(self.ct.shape[:-1])})"


class FheUint:
    """A (batch of) encrypted W-bit unsigned integer(s): bit batches
    int32 [..., W, n0+1], LSB first (bit_utils layout).

    `+`/`-` are Kogge-Stone adders, `*` the carry-save multiplier, `//`/`%`
    restoring division (models.circuits); comparisons return `FheBool`;
    shifts by plaintext amounts are free row moves. All results mod 2^W.
    """

    __slots__ = ("bits", "ck")

    def __init__(self, bits: torch.Tensor, ck: CloudKey):
        self.bits = bits
        self.ck = ck

    @property
    def width(self) -> int:
        return self.bits.shape[-2]

    # -- client side ------------------------------------------------------
    @classmethod
    def encrypt(cls, generator, sk_lv0: torch.Tensor, values, width: int, ck: CloudKey):
        """Encrypt an int or an integer array as width-bit encrypted integers."""
        return cls(lwe_encrypt_bool(generator, sk_lv0, _bits_of(values, width), ck.params.tlwe_lv0.alpha), ck)

    @classmethod
    def trivial(cls, values, width: int, ck: CloudKey):
        return cls(lwe_trivial_bool(_bits_of(values, width), ck.params.tlwe_lv0.n, _device(ck)), ck)

    def decrypt(self, sk_lv0: torch.Tensor) -> np.ndarray:
        bits = lwe_decrypt_bool(self.bits, sk_lv0).cpu().numpy()
        vals = np.zeros(bits.shape[:-1], dtype=np.uint64)
        for i in range(bits.shape[-1]):
            vals |= bits[..., i].astype(np.uint64) << np.uint64(i)
        return vals

    # -- server side ------------------------------------------------------
    def _coerce(self, other) -> "FheUint":
        if isinstance(other, FheUint):
            if other.width != self.width:
                raise ValueError(f"width mismatch: {self.width} vs {other.width}")
            return other
        return type(self).trivial(np.broadcast_to(np.asarray(other), self.bits.shape[:-2]), self.width, self.ck)

    def _false(self) -> torch.Tensor:
        return gates.constant(False, 1, self.ck.params, device=self.bits.device)[0]

    def __add__(self, other):
        return type(self)(circuits.add_kogge_stone(self.bits, self._coerce(other).bits, self.ck), self.ck)

    __radd__ = __add__

    def __sub__(self, other):
        return type(self)(circuits.sub(self.bits, self._coerce(other).bits, self.ck), self.ck)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        """Carry-save multiply mod 2^W (circuits.mul_csa)."""
        return type(self)(circuits.mul_csa(self.bits, self._coerce(other).bits, self.ck), self.ck)

    __rmul__ = __mul__

    def divmod(self, other):
        """Encrypted (self // other, self % other) by restoring long division
        (circuits.divmod_bits); division by an encrypted zero gives
        (2^W - 1, self)."""
        q, r = circuits.divmod_bits(self.bits, self._coerce(other).bits, self.ck)
        return type(self)(q, self.ck), type(self)(r, self.ck)

    def __floordiv__(self, other):
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(other)[1]

    # bitwise: one batched gate each
    def __and__(self, other):
        return type(self)(gates.and_(self.bits, self._coerce(other).bits, self.ck), self.ck)

    def __or__(self, other):
        return type(self)(gates.or_(self.bits, self._coerce(other).bits, self.ck), self.ck)

    def __xor__(self, other):
        return type(self)(gates.xor(self.bits, self._coerce(other).bits, self.ck), self.ck)

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return type(self)(gates.not_(self.bits), self.ck)

    # plaintext-amount shifts are free row moves (mod 2^W)
    def __lshift__(self, k: int):
        return type(self)(circuits._shift_up(self.bits, k, self._false()), self.ck)

    def __rshift__(self, k: int):
        pad = self._false().expand(*self.bits.shape[:-2], k, self.bits.shape[-1])
        return type(self)(torch.cat([self.bits[..., k:, :], pad], dim=-2), self.ck)

    def to_radix(self, base_bits: int = 3, num_digits: int | None = None) -> "FheUintRadix":
        """Cast to the radix representation in two batched blind rotations
        (arithmetic.bits_to_radix)."""
        d = num_digits if num_digits is not None else -(-self.width // base_bits)
        return FheUintRadix(arithmetic.bits_to_radix(self.bits, self.ck, base_bits, d), base_bits, self.ck)

    # comparisons -> FheBool
    def __gt__(self, other):
        return FheBool(circuits.greater_than(self.bits, self._coerce(other).bits, self.ck), self.ck)

    def __lt__(self, other):
        return FheBool(circuits.greater_than(self._coerce(other).bits, self.bits, self.ck), self.ck)

    def __ge__(self, other):
        return ~self.__lt__(other)

    def __le__(self, other):
        return ~self.__gt__(other)

    def __eq__(self, other):  # noqa: D105 - returns FheBool, like numpy
        return FheBool(circuits.equals(self.bits, self._coerce(other).bits, self.ck), self.ck)

    def __ne__(self, other):
        return ~self.__eq__(other)

    __hash__ = None

    def __repr__(self):
        return f"FheUint{self.width}(batch={tuple(self.bits.shape[:-2])})"


class FheInt(FheUint):
    """A (batch of) encrypted W-bit signed integer(s), two's complement.

    `+`, `-`, `*`, bitwise operators and `<<` are the unsigned circuits; this
    class changes what the sign changes: decryption, comparisons (MSB flip,
    then the unsigned compare), arithmetic `>>` and division truncated toward
    zero (-7 // 2 == -3; the remainder takes the dividend's sign).
    """

    def decrypt(self, sk_lv0: torch.Tensor) -> np.ndarray:
        u = super().decrypt(sk_lv0).astype(np.int64)
        return u - ((u >> (self.width - 1)) << self.width)

    def _flip_msb(self) -> torch.Tensor:
        """Signed order onto unsigned order: x ^ 2^(W-1), a free NOT on the MSB row."""
        return torch.cat([self.bits[..., :-1, :], gates.not_(self.bits[..., -1:, :])], dim=-2)

    def __gt__(self, other):
        o = self._coerce(other)
        return FheBool(circuits.greater_than(self._flip_msb(), o._flip_msb(), self.ck), self.ck)

    def __lt__(self, other):
        o = self._coerce(other)
        return FheBool(circuits.greater_than(o._flip_msb(), self._flip_msb(), self.ck), self.ck)

    def __rshift__(self, k: int):
        """Arithmetic shift: the vacated high bits copy the sign bit."""
        pad = self.bits[..., -1:, :].expand(*self.bits.shape[:-2], k, self.bits.shape[-1])
        return type(self)(torch.cat([self.bits[..., k:, :], pad], dim=-2), self.ck)

    def sign_bit(self) -> FheBool:
        """The encrypted sign (True = negative)."""
        return FheBool(self.bits[..., -1, :], self.ck)

    def abs(self) -> "FheInt":
        """|self| (|INT_MIN| wraps to INT_MIN)."""
        return self.sign_bit().select(0 - self, self)

    def divmod(self, other):
        """Division truncated toward zero on the unsigned divider: |a| by |b|,
        then the signs (quotient negative iff the signs differ, remainder with
        the dividend's). By an encrypted zero: quotient -1, remainder self."""
        o = self._coerce(other)
        sa, sb = self.sign_bit(), o.sign_bit()
        qu, ru = FheUint.divmod(self.abs(), o.abs())
        q = (sa ^ sb).select(0 - qu, qu)
        r = sa.select(0 - ru, ru)
        return type(self)(q.bits, self.ck), type(self)(r.bits, self.ck)

    def __repr__(self):
        return f"FheInt{self.width}(batch={tuple(self.bits.shape[:-2])})"


class FheUintRadix:
    """A (batch of) encrypted unsigned integer(s) as base-2^b digit vectors
    int32 [..., D, n0+1] (models.arithmetic encoding): `+` in 2D-1
    programmable bootstraps, `*` the full-width product (2D digits), `apply`
    any per-digit function in one batched PBS.

    Use SECURITY_128_BIT_RADIX (base_bits <= 3) or SECURITY_128_BIT_NIBBLE
    (base_bits = 4). multi_value=True sends `+`, `-` and the comparison tree
    through the multi-value bootstrap (about half the rotations, the same
    decoded results); results inherit it.
    """

    __slots__ = ("digits", "base_bits", "ck", "multi_value")

    def __init__(self, digits: torch.Tensor, base_bits: int, ck: CloudKey, multi_value: bool = False):
        self.digits = digits
        self.base_bits = base_bits
        self.ck = ck
        self.multi_value = multi_value

    def _like(self, digits: torch.Tensor) -> "FheUintRadix":
        return FheUintRadix(digits, self.base_bits, self.ck, self.multi_value)

    @property
    def num_digits(self) -> int:
        return self.digits.shape[-2]

    # -- client side ------------------------------------------------------
    @classmethod
    def encrypt(cls, generator, sk_lv0: torch.Tensor, values, num_digits: int, ck: CloudKey,
                base_bits: int = 3, multi_value: bool = False):
        ct = arithmetic.encrypt_radix(generator, sk_lv0, values, num_digits, ck.params, base_bits)
        return cls(ct, base_bits, ck, multi_value)

    @classmethod
    def trivial(cls, values, num_digits: int, ck: CloudKey, base_bits: int = 3):
        digits = arithmetic._digits_of(values, num_digits, base_bits)
        ct = lwe_trivial_message(digits, 1 << (base_bits + 1), ck.params.tlwe_lv0.n, _device(ck))
        return cls(ct, base_bits, ck)  # trivial ciphertexts carry no multi-value history

    def decrypt(self, sk_lv0: torch.Tensor) -> np.ndarray:
        return arithmetic.decrypt_radix(self.digits, sk_lv0, self.base_bits)

    # -- server side ------------------------------------------------------
    def _coerce(self, other) -> "FheUintRadix":
        if isinstance(other, FheUintRadix):
            if other.base_bits != self.base_bits:
                raise ValueError("base_bits mismatch")
            if other.num_digits != self.num_digits:
                raise ValueError("digit-count mismatch")
            return other
        vals = np.broadcast_to(np.asarray(other), self.digits.shape[:-2])
        return FheUintRadix.trivial(vals, self.num_digits, self.ck, self.base_bits)

    def __add__(self, other):
        o = self._coerce(other)
        return self._like(arithmetic.add_radix(self.digits, o.digits, self.ck, self.base_bits,
                                               multi_value=self.multi_value))

    __radd__ = __add__

    def __sub__(self, other):
        """a - b mod base^D through the radix complement (2D PBS)."""
        o = self._coerce(other)
        return self._like(arithmetic.sub_radix(self.digits, o.digits, self.ck, self.base_bits,
                                               multi_value=self.multi_value))

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        """Full-width product: the result has 2D digits."""
        o = self._coerce(other)
        return self._like(arithmetic.mul_radix(self.digits, o.digits, self.ck, self.base_bits))

    __rmul__ = __mul__

    def apply(self, f) -> "FheUintRadix":
        """A plaintext function digit-wise, in one batched PBS."""
        return self._like(arithmetic.apply_lut_radix(self.digits, f, self.ck, self.base_bits))

    def to_bits(self) -> FheUint:
        """Cast to an FheUint of width D * base_bits in one batched blind
        rotation (arithmetic.radix_to_bits)."""
        return FheUint(arithmetic.radix_to_bits(self.digits, self.ck, self.base_bits), self.ck)

    def shift_digits(self, k: int) -> "FheUintRadix":
        """Multiply (k > 0) or divide (k < 0) by base^k mod base^D: free digit moves."""
        return self._like(arithmetic.shift_digits(self.digits, k, self.base_bits))

    # comparisons -> FheBool (one MSB-first trichotomy tree each)
    def compare(self, other):
        """(eq, gt, lt) as FheBools from one tree evaluation."""
        o = self._coerce(other)
        eq, gt, lt = arithmetic.compare_radix(self.digits, o.digits, self.ck, self.base_bits,
                                              multi_value=self.multi_value)
        return FheBool(eq, self.ck), FheBool(gt, self.ck), FheBool(lt, self.ck)

    def __eq__(self, other):  # noqa: D105 - returns FheBool, like numpy
        return self.compare(other)[0]

    def __ne__(self, other):
        return ~self.compare(other)[0]

    def __gt__(self, other):
        return self.compare(other)[1]

    def __lt__(self, other):
        return self.compare(other)[2]

    def __ge__(self, other):
        return ~self.compare(other)[2]

    def __le__(self, other):
        return ~self.compare(other)[1]

    def min(self, other) -> "FheUintRadix":
        """Encrypted element-wise minimum (compare tree, 3-rotation select)."""
        o = self._coerce(other)
        return self._like(arithmetic.min_radix(self.digits, o.digits, self.ck, self.base_bits,
                                               multi_value=self.multi_value))

    def max(self, other) -> "FheUintRadix":
        """Encrypted element-wise maximum."""
        o = self._coerce(other)
        return self._like(arithmetic.max_radix(self.digits, o.digits, self.ck, self.base_bits,
                                               multi_value=self.multi_value))

    __hash__ = None

    def __repr__(self):
        return f"FheUintRadix(D={self.num_digits}, base=2^{self.base_bits}, batch={tuple(self.digits.shape[:-2])})"

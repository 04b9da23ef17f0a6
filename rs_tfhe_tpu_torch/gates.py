"""Homomorphic boolean gates, batch-first.

Every two-input gate is a wrapping int32 linear combination of the input
batches plus a constant torus bias on the body, followed by one gate
bootstrap (reference gates.rs:54-218). All functions take ciphertext batches
int32 [B, n0+1]; a single ciphertext is B = 1, and the batch axis is the
parallelism on the card.
"""

from __future__ import annotations

import torch

from . import bootstrap as bs
from .key import CloudKey
from .ops.keyswitch import identity_key_switch
from .tlwe import lwe_add_bias as _biased
from .torus import f64_to_torus, i32, neg_torus, resolve_device
from .utils.profiling import span

_BIAS_1_8 = i32(int(f64_to_torus(0.125)))
_BIAS_M1_8 = i32(int(f64_to_torus(-0.125)))
_BIAS_1_4 = i32(int(f64_to_torus(0.25)))
_BIAS_M1_4 = i32(int(f64_to_torus(-0.25)))


# ---------------------------------------------------------------------------
# Gate linear forms (reference gates.rs equations)
# ---------------------------------------------------------------------------

def _nand_lin(a, b):
    return _biased(neg_torus(a + b), _BIAS_1_8)  # gates.rs:54-58


def _or_lin(a, b):
    return _biased(a + b, _BIAS_1_8)  # gates.rs:62-66


def _and_lin(a, b):
    return _biased(a + b, _BIAS_M1_8)  # gates.rs:70-74


def _xor_lin(a, b):
    return _biased(a + b * 2, _BIAS_1_4)  # gates.rs:78-82


def _xnor_lin(a, b):
    # XNOR = -2(a+b) - 1/4. The reference's xnor (gates.rs:86-90, a - 2b - 1/4)
    # evaluates XOR; the JAX package and the port implement true XNOR.
    return _biased(neg_torus(a + b) * 2, _BIAS_M1_4)


def _nor_lin(a, b):
    return _biased(neg_torus(a + b), _BIAS_M1_8)  # gates.rs:94-98


def _and_ny_lin(a, b):
    return _biased(neg_torus(a) + b, _BIAS_M1_8)  # gates.rs:102-111 ((not a) and b)


def _and_yn_lin(a, b):
    return _biased(a - b, _BIAS_M1_8)  # gates.rs:115-124 (a and (not b))


def _or_ny_lin(a, b):
    return _biased(neg_torus(a) + b, _BIAS_1_8)  # gates.rs:128-137 ((not a) or b)


def _or_yn_lin(a, b):
    return _biased(a - b, _BIAS_1_8)  # gates.rs:141-150 (a or (not b))


_LINEAR_FORMS = {
    "nand": _nand_lin,
    "or": _or_lin,
    "and": _and_lin,
    "xor": _xor_lin,
    "xnor": _xnor_lin,
    "nor": _nor_lin,
    "and_ny": _and_ny_lin,
    "and_yn": _and_yn_lin,
    "or_ny": _or_ny_lin,
    "or_yn": _or_yn_lin,
}


def batch_gate(name: str, a: torch.Tensor, b: torch.Tensor, ck: CloudKey) -> torch.Tensor:
    """Evaluate one two-input gate over a whole batch with a single bootstrap
    (the analogue of the reference's batch_nand/batch_and/..., gates.rs:352-547)."""
    with span("tfhe.gate"):
        return bs.bootstrap(_LINEAR_FORMS[name](a, b), ck)


def nand(a, b, ck):
    return batch_gate("nand", a, b, ck)


def or_(a, b, ck):
    return batch_gate("or", a, b, ck)


def and_(a, b, ck):
    return batch_gate("and", a, b, ck)


def xor(a, b, ck):
    return batch_gate("xor", a, b, ck)


def xnor(a, b, ck):
    return batch_gate("xnor", a, b, ck)


def nor(a, b, ck):
    return batch_gate("nor", a, b, ck)


def and_ny(a, b, ck):
    return batch_gate("and_ny", a, b, ck)


def and_yn(a, b, ck):
    return batch_gate("and_yn", a, b, ck)


def or_ny(a, b, ck):
    return batch_gate("or_ny", a, b, ck)


def or_yn(a, b, ck):
    return batch_gate("or_yn", a, b, ck)


def mux(a, b, c, ck):
    """MUX(a; b, c) = a ? b : c with 2 blind rotations + 1 key switch.

    As in the JAX package (gates.py:118-134): u1 = BS(a and b) and
    u2 = BS(!a and c) are fresh +/-1/8 lv1 encryptions, so u1 + u2 + 1/8
    decides OR by sign without a third bootstrap; one key switch returns to lv0.
    """
    with span("tfhe.gate"):
        u1 = bs.bootstrap_without_key_switch(_and_lin(a, b), ck)
        u2 = bs.bootstrap_without_key_switch(_and_lin(neg_torus(a), c), ck)
        return identity_key_switch(_biased(u1 + u2, _BIAS_1_8), ck.ksk_limbs, ck.params)


def mux_naive(a, b, c, ck):
    """3-gate MUX (reference gates.rs:189-199): OR(AND(a, b), AND(NOT a, c))."""
    return or_(and_(a, b, ck), and_(not_(a), c, ck), ck)


def not_(a):
    """Bootstrap-free NOT (reference gates.rs:202-204)."""
    return neg_torus(a)


def copy(a):
    return a


def constant(value, batch: int, params, device=None) -> torch.Tensor:
    """Trivial (noiseless) ciphertext of a constant (reference gates.rs:212-218).

    Keeps the reference's exact torus values: mu for true, 1 - mu for false
    (a 1-ulp quirk of gates.rs:214, kept for parity). On `device` (None:
    the card, torus.resolve_device); circuits pass their ciphertexts' device.
    """
    device = resolve_device(device)
    ct = torch.zeros((batch, params.n0 + 1), dtype=torch.int32, device=device)
    if isinstance(value, bool):  # filled on the device, no host-to-device copy
        ct[:, -1] = _BIAS_1_8 if value else i32(1 - _BIAS_1_8)
    else:
        value = torch.as_tensor(value, dtype=torch.bool, device=device).expand(batch)
        ct[:, -1] = torch.where(value, _BIAS_1_8, i32(1 - _BIAS_1_8)).to(torch.int32)
    return ct


class Gates:
    """Gate API with an injectable bootstrap strategy (reference
    gates.rs:30-49; rs_tfhe_tpu/gates.py:208-283).

    With no strategy every gate is the module's function above; with one,
    every gate's linear form is refreshed by `strategy.bootstrap_gate` (or
    `strategy.bootstrap` where it has none), and MUX is composed from the
    strategy's lv1 bootstraps with one key switch.
    """

    def __init__(self, strategy=None):
        self._strategy = strategy

    @property
    def bootstrap_strategy(self) -> str:
        return self._strategy.name if self._strategy else "vanilla"

    def _run(self, name, a, b, ck):
        if self._strategy is None:
            return batch_gate(name, a, b, ck)
        # the linear forms use the +/-1/8 boolean encoding: a strategy
        # refreshes them through bootstrap_gate (its generic bootstrap may be
        # defined over a message encoding, as LutBootstrap's is)
        refresh = getattr(self._strategy, "bootstrap_gate", self._strategy.bootstrap)
        return refresh(_LINEAR_FORMS[name](a, b), ck)

    def nand(self, a, b, ck):
        return self._run("nand", a, b, ck)

    def or_(self, a, b, ck):
        return self._run("or", a, b, ck)

    def and_(self, a, b, ck):
        return self._run("and", a, b, ck)

    def xor(self, a, b, ck):
        return self._run("xor", a, b, ck)

    def xnor(self, a, b, ck):
        return self._run("xnor", a, b, ck)

    def nor(self, a, b, ck):
        return self._run("nor", a, b, ck)

    def and_ny(self, a, b, ck):
        return self._run("and_ny", a, b, ck)

    def and_yn(self, a, b, ck):
        return self._run("and_yn", a, b, ck)

    def or_ny(self, a, b, ck):
        return self._run("or_ny", a, b, ck)

    def or_yn(self, a, b, ck):
        return self._run("or_yn", a, b, ck)

    def mux(self, a, b, c, ck):
        if self._strategy is None:
            return mux(a, b, c, ck)
        u1 = self._strategy.bootstrap_without_key_switch(_and_lin(a, b), ck)
        u2 = self._strategy.bootstrap_without_key_switch(_and_lin(neg_torus(a), c), ck)
        return identity_key_switch(_biased(u1 + u2, _BIAS_1_8), ck.ksk_limbs, ck.params)

    def mux_naive(self, a, b, c, ck):
        """The 3-gate MUX through this object's (strategy-aware) gates."""
        return self.or_(self.and_(a, b, ck), self.and_(not_(a), c, ck), ck)

    def not_(self, a):
        return not_(a)

    def copy(self, a):
        return copy(a)

    def constant(self, value, batch, params, device=None):
        return constant(value, batch, params, device)

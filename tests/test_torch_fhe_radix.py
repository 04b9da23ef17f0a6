"""PyTorch port: FheUintRadix, the digit-level typed API (`fhe.py`), and the
casts between it and FheUint, against the JAX package with tolerance 0, on
JAX keys and ciphertexts carried into the port with a standard key; every
result also decrypts to the numpy answer.

The N=512 tiny set of tests/test_mul_radix.py (copied) gives the radix LUTs
their margins. JAX runs each group of operators under one jax.jit, its LUT
caches filled first. Under jit a plaintext operand cannot be coerced, so
the coercion of plain operands is held in tests/test_torch_fhe.py. JAX's comparison
operators are its `compare` triple (`<` is `compare(...)[2]`, `>=` its NOT,
and so on): the reference computes them once, the port each operator on its
own.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import fhe as JF  # noqa: E402
from rs_tfhe_tpu import gates as JG  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch import fhe as PF  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: tests/test_mul_radix.py:25-33
MP = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)
PMP = params_from(MP)
BB = 2  # base 4 digits
RX, RY = np.array([13, 6]), np.array([9, 6])  # two digits: 4-bit values
M = 16


@pytest.fixture(scope="module")
def keys():
    jsk = JSecretKey.generate(jax.random.key(212), MP)
    jck = JCloudKey.generate(jax.random.key(213), jsk)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    for fill in (JA._add_mv, JA._cmp_luts, JA._cmp_mv, JA._sel_luts, JA._cast_luts):
        fill(BB, MP)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PMP, "cpu"), PK.cloud_key_from_numpy(arrays, PMP, "cpu")


def _radix(keys, seed, vals, mv=False):
    """A JAX FheUintRadix of vals and the port's on the same words."""
    jsk, jck, _, pck = keys
    j = JF.FheUintRadix.encrypt(jax.random.key(seed), jsk.lv0, vals, 2, jck, BB, multi_value=mv)
    return j, PF.FheUintRadix(to_torch(np.asarray(j.digits), "cpu"), BB, pck, mv)


def _words(obj) -> np.ndarray:
    val = obj.ct if isinstance(obj, PF.FheBool) else obj.digits if isinstance(obj, PF.FheUintRadix) else obj.bits
    return to_numpy(val)


def _apply_want(vals):
    return ((vals & 3) + 1) % 4 + ((((vals >> 2) + 1) % 4) << 2)


@pytest.mark.parametrize("mv", [False, True], ids=["pbs", "multi_value"])
def test_fhe_uint_radix_matches_jax(keys, mv):
    """+, -, *, apply, shift_digits both ways, compare and the six comparison
    operators, min and max; with multi_value (sticky) the operators it
    reaches: +, -, the comparisons and min (max is min's select with the
    branches swapped)."""
    jsk, jck, psk, pck = keys
    jx, x = _radix(keys, 230, RX, mv)
    jy, y = _radix(keys, 231, RY, mv)

    def run(xd, yd, ck):
        a, b = JF.FheUintRadix(xd, BB, ck, mv), JF.FheUintRadix(yd, BB, ck, mv)
        eq, gt, lt = (v.ct for v in a.compare(b))
        nots = {k: JG.not_(v) for k, v in (("ne", eq), ("le", gt), ("ge", lt))}
        out = {"add": (a + b).digits, "sub": (a - b).digits, "min": a.min(b).digits, "eq": eq, "gt": gt, "lt": lt,
               **nots}
        if not mv:  # the rest ignore multi_value: once
            out.update(mul=(a * b).digits, apply=a.apply(lambda v: (v + 1) % 4).digits,
                       shift_up=a.shift_digits(1).digits, shift_down=a.shift_digits(-1).digits,
                       max=a.max(b).digits)
        return out

    refs = jax.jit(run)(jx.digits, jy.digits, jck)
    ops = {
        "add": (lambda a, b: a + b, (RX + RY) % M), "sub": (lambda a, b: a - b, (RX - RY) % M),
        "mul": (lambda a, b: a * b, RX * RY), "apply": (lambda a, b: a.apply(lambda v: (v + 1) % 4), _apply_want(RX)),
        "shift_up": (lambda a, b: a.shift_digits(1), (RX << 2) % M), "shift_down": (lambda a, b: a.shift_digits(-1), RX >> 2),
        "min": (lambda a, b: a.min(b), np.minimum(RX, RY)), "max": (lambda a, b: a.max(b), np.maximum(RX, RY)),
        "eq": (lambda a, b: a == b, RX == RY), "gt": (lambda a, b: a > b, RX > RY), "lt": (lambda a, b: a < b, RX < RY),
        "ne": (lambda a, b: a != b, RX != RY), "le": (lambda a, b: a <= b, RX <= RY), "ge": (lambda a, b: a >= b, RX >= RY),
    }
    for name, (op, want) in ops.items():
        if name not in refs:
            continue
        got = op(x, y)
        np.testing.assert_array_equal(_words(got), np.asarray(refs[name]), err_msg=name)
        np.testing.assert_array_equal(got.decrypt(psk.lv0), want, err_msg=name)
        if isinstance(got, PF.FheUintRadix):
            assert got.multi_value == mv and got.base_bits == BB and got.ck is pck
    eq, gt, lt = x.compare(y)
    for got, name in ((eq, "eq"), (gt, "gt"), (lt, "lt")):
        np.testing.assert_array_equal(_words(got), np.asarray(refs[name]))
    assert x.num_digits == 2 and repr(x) == repr(jx) == "FheUintRadix(D=2, base=2^2, batch=(2,))"


def test_fhe_radix_bit_casts_match_jax(keys):
    """FheUintRadix.to_bits and FheUint.to_radix, both ways through the casts."""
    jsk, jck, psk, pck = keys
    jx, x = _radix(keys, 232, RX)

    def run(xd, ck):
        bits = JF.FheUintRadix(xd, BB, ck).to_bits()
        return bits.bits, bits.to_radix(BB).digits

    ref_bits, ref_back = jax.jit(run)(jx.digits, jck)
    bits = x.to_bits()
    assert isinstance(bits, PF.FheUint) and bits.width == 4
    np.testing.assert_array_equal(_words(bits), np.asarray(ref_bits))
    np.testing.assert_array_equal(bits.decrypt(psk.lv0), RX)
    back = bits.to_radix(BB)
    assert isinstance(back, PF.FheUintRadix) and back.num_digits == 2 and back.base_bits == BB
    np.testing.assert_array_equal(_words(back), np.asarray(ref_back))
    np.testing.assert_array_equal(back.decrypt(psk.lv0), RX)

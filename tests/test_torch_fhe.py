"""PyTorch port: the bit-level typed API (`fhe.py`: FheBool, FheUint,
FheInt) against the JAX package with tolerance 0, on JAX keys and
ciphertexts carried into the port at TEST_TINY: FheBool with a multi-bit key
(its batches of 4 take the multi-bit rotation), FheUint with a standard key;
every result also decrypts to the numpy answer. JAX
evaluates the operators eagerly (its gates are jitted). Also the ValueErrors
of `_coerce` (with FheUintRadix's), FheUintRadix's coercion of plain
operands on the N=512 tiny set of tests/test_mul_radix.py (copied), and the
port's own client side.
tests/test_torch_fhe_int.py holds the division and FheInt,
tests/test_torch_fhe_radix.py FheUintRadix.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import fhe as JF  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY, TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
import rs_tfhe_tpu_torch as pt  # noqa: E402
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
BB = 2  # radix base 4
RX, RY = np.array([13, 6]), np.array([9, 6])  # two radix digits: 4-bit values
M = 16
W = 3
XS, YS = np.array([6, 3]), np.array([2, 5])  # FheUint operands (W bits)


def _keys(params, multibit: bool, seed: int):
    jsk = JSecretKey.generate(jax.random.key(seed), params)
    jck = JCloudKey.generate(jax.random.key(seed + 1), jsk, multibit=multibit)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if multibit:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    pp = params_from(params)
    return jsk, jck, PK.secret_key_from_numpy(arrays, pp, "cpu"), PK.cloud_key_from_numpy(arrays, pp, "cpu")


@pytest.fixture(scope="module")
def bits_keys():
    """TEST_TINY keys with a multi-bit key, for FheBool."""
    return _keys(TEST_TINY, True, 210)


@pytest.fixture(scope="module")
def std_keys():
    """TEST_TINY keys with a standard key, for FheUint's circuits (JAX
    compiles every gate shape once a route; one route halves that)."""
    return _keys(TEST_TINY, False, 214)


@pytest.fixture(scope="module")
def radix_keys():
    """N=512 keys with a standard key, for FheUintRadix."""
    for fill in (JA._add_mv, JA._cmp_luts, JA._sel_luts):
        fill(BB, MP)
    return _keys(MP, False, 218)


def _radix(keys, seed, vals):
    """A JAX FheUintRadix of vals and the port's on the same words."""
    jsk, jck, _, pck = keys
    j = JF.FheUintRadix.encrypt(jax.random.key(seed), jsk.lv0, vals, 2, jck, BB)
    return j, PF.FheUintRadix(to_torch(np.asarray(j.digits), "cpu"), BB, pck)


def _pair(jobj, cls, *extra):
    """A JAX typed object and the port's on the same words."""
    field = {"FheBool": "ct", "FheUint": "bits", "FheInt": "bits", "FheUintRadix": "digits"}[cls.__name__]
    return cls(to_torch(np.asarray(getattr(jobj, field)), "cpu"), *extra)


def _words(obj) -> np.ndarray:
    for field in ("ct", "bits", "digits"):
        if hasattr(obj, field):
            val = getattr(obj, field)
            return to_numpy(val) if isinstance(val, torch.Tensor) else np.asarray(val)
    raise TypeError(obj)


def _check(got, ref, sk_lv0, want):
    np.testing.assert_array_equal(_words(got), _words(ref))
    np.testing.assert_array_equal(got.decrypt(sk_lv0), want)


def test_fhe_bool_matches_jax(bits_keys):
    jsk, jck, psk, pck = bits_keys
    av, bv, cv = np.array([True, True, False, False]), np.array([True, False, True, False]), np.array([False, True, True, False])
    ja, jb, jc = (JF.FheBool.encrypt(jax.random.key(220 + i), jsk.lv0, v, jck) for i, v in enumerate((av, bv, cv)))
    a, b, c = (_pair(j, PF.FheBool, pck) for j in (ja, jb, jc))
    cases = [
        (lambda x, y, z: x & y, av & bv), (lambda x, y, z: x | y, av | bv), (lambda x, y, z: x ^ y, av ^ bv),
        (lambda x, y, z: ~x, ~av), (lambda x, y, z: x.select(y, z), np.where(av, bv, cv)),
        (lambda x, y, z: x & True, av), (lambda x, y, z: False | x, av), (lambda x, y, z: True ^ x, ~av), (lambda x, y, z: x ^ cv, av ^ cv),
    ]
    for op, want in cases:
        _check(op(a, b, c), op(ja, jb, jc), psk.lv0, want)
    assert repr(a) == repr(ja) == "FheBool(batch=(4,))"


def test_fhe_uint_matches_jax(std_keys):
    """Arithmetic, bitwise operators, shifts, comparisons and plain ints on
    either side, W = 3 bits (mod 8)."""
    jsk, jck, psk, pck = std_keys
    jx = JF.FheUint.encrypt(jax.random.key(224), jsk.lv0, XS, W, jck)
    jy = JF.FheUint.encrypt(jax.random.key(225), jsk.lv0, YS, W, jck)
    x, y = _pair(jx, PF.FheUint, pck), _pair(jy, PF.FheUint, pck)
    m = 1 << W
    cases = [
        (lambda a, b: a + b, (XS + YS) % m), (lambda a, b: a - b, (XS - YS) % m), (lambda a, b: a * b, XS * YS % m),
        (lambda a, b: a & b, XS & YS), (lambda a, b: a | b, XS | YS), (lambda a, b: a ^ b, XS ^ YS),
        (lambda a, b: ~a, ~XS % m), (lambda a, b: a << 1, (XS << 1) % m), (lambda a, b: a >> 2, XS >> 2),
        (lambda a, b: a + 5, (XS + 5) % m), (lambda a, b: 5 + a, (XS + 5) % m), (lambda a, b: 1 - a, (1 - XS) % m),
        (lambda a, b: 3 * a, 3 * XS % m), (lambda a, b: a & 6, XS & 6),
    ]
    for op, want in cases:
        _check(op(x, y), op(jx, jy), psk.lv0, want)
    comparisons = [
        (lambda a, b: a < b, XS < YS), (lambda a, b: a > b, XS > YS), (lambda a, b: a <= b, XS <= YS),
        (lambda a, b: a >= b, XS >= YS), (lambda a, b: a == b, XS == YS), (lambda a, b: a != b, XS != YS),
        (lambda a, b: a > 4, XS > 4),
    ]
    for op, want in comparisons:
        _check(op(x, y), op(jx, jy), psk.lv0, want)
    assert repr(x) == repr(jx) == "FheUint3(batch=(2,))" and x.width == W
    sel = JF.FheBool.encrypt(jax.random.key(226), jsk.lv0, np.array([True, False]), jck)
    _check(_pair(sel, PF.FheBool, pck).select(x, y), sel.select(jx, jy), psk.lv0, np.where([True, False], XS, YS))


def test_fhe_uint_radix_coercion_matches_jax(radix_keys):
    """Plain ints on either side: the trivial operand equals JAX's, and so
    does the operator on it (x + 3, 3 + x, 11 - x, x < 7); FheBool.select
    over radix branches."""
    jsk, jck, psk, pck = radix_keys
    jx, x = _radix(radix_keys, 233, RX)
    jy, y = _radix(radix_keys, 234, RY)
    for plain in (3, 7, 11, np.array([1, 14])):
        np.testing.assert_array_equal(to_numpy(x._coerce(plain).digits), np.asarray(jx._coerce(plain).digits))
    three, seven, eleven = (jx._coerce(v).digits for v in (3, 7, 11))
    sel_bits = np.array([False, True])
    jsel = JF.FheBool.encrypt(jax.random.key(235), jsk.lv0, sel_bits, jck)

    def run(xd, yd, s, t3, t7, t11, ck):
        a, b = JF.FheUintRadix(xd, BB, ck), JF.FheUintRadix(yd, BB, ck)
        c3, c7, c11 = (JF.FheUintRadix(t, BB, ck) for t in (t3, t7, t11))
        return ((a + c3).digits, (c3 + a).digits, (c11 - a).digits, (a < c7).ct,
                JF.FheBool(s, ck).select(a, b).digits)

    refs = jax.jit(run)(jx.digits, jy.digits, jsel.ct, three, seven, eleven, jck)
    psel = PF.FheBool(to_torch(np.asarray(jsel.ct), "cpu"), pck)
    gots = (x + 3, 3 + x, 11 - x, x < 7, psel.select(x, y))
    wants = ((RX + 3) % M, (RX + 3) % M, (11 - RX) % M, RX < 7, np.where(sel_bits, RX, RY))
    for got, ref, want in zip(gots, refs, wants):
        np.testing.assert_array_equal(_words(got), np.asarray(ref))
        np.testing.assert_array_equal(got.decrypt(psk.lv0), want)


def test_coerce_errors_match_jax(bits_keys):
    """The ValueErrors of _coerce, message for message."""
    jsk, jck, psk, pck = bits_keys
    zeros = np.zeros((1, 3, TEST_TINY.n0 + 1), np.uint32)
    cases = [
        (JF.FheUint(zeros, jck), JF.FheUint(zeros[:, :2], jck),
         PF.FheUint(to_torch(zeros, "cpu"), pck), PF.FheUint(to_torch(zeros[:, :2], "cpu"), pck)),
        (JF.FheUintRadix(zeros, 2, jck), JF.FheUintRadix(zeros, 3, jck),
         PF.FheUintRadix(to_torch(zeros, "cpu"), 2, pck), PF.FheUintRadix(to_torch(zeros, "cpu"), 3, pck)),
        (JF.FheUintRadix(zeros, 2, jck), JF.FheUintRadix(zeros[:, :2], 2, jck),
         PF.FheUintRadix(to_torch(zeros, "cpu"), 2, pck), PF.FheUintRadix(to_torch(zeros[:, :2], "cpu"), 2, pck)),
    ]
    for ja, jb, pa, pb in cases:
        with pytest.raises(ValueError) as jerr:
            ja._coerce(jb)
        with pytest.raises(ValueError) as perr:
            pa._coerce(pb)
        assert str(perr.value) == str(jerr.value)


def test_fhe_client_side_on_the_port(bits_keys):
    """encrypt with a torch.Generator, trivial and decrypt (numpy) in the
    port alone, and the package-level exports."""
    psk, pck = bits_keys[2], bits_keys[3]
    g = torch.Generator().manual_seed(235)
    assert pt.FheBool is PF.FheBool and pt.FheUintRadix is PF.FheUintRadix and pt.FheInt is PF.FheInt
    b = PF.FheBool.encrypt(g, psk.lv0, [True, False], pck)
    assert isinstance(b.decrypt(psk.lv0), np.ndarray) and b.decrypt(psk.lv0).tolist() == [True, False]
    u = PF.FheUint.encrypt(g, psk.lv0, np.array([5, 250]), 8, pck)
    assert u.decrypt(psk.lv0).dtype == np.uint64 and u.decrypt(psk.lv0).tolist() == [5, 250]
    i = PF.FheInt.encrypt(g, psk.lv0, np.array([-7, 100]), 8, pck)
    assert i.decrypt(psk.lv0).tolist() == [-7, 100]
    r = PF.FheUintRadix.encrypt(g, psk.lv0, np.array([300, 7]), 5, pck, 2)
    assert r.decrypt(psk.lv0).tolist() == [300, 7]
    assert PF.FheUintRadix.trivial(np.array([9]), 2, pck, 2).decrypt(psk.lv0).tolist() == [9]
    assert PF.FheUint.trivial(6, 3, pck).decrypt(psk.lv0).tolist() == 6

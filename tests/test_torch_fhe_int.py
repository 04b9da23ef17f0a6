"""PyTorch port: division in the bit-level typed API (`fhe.py`: FheUint's
`//` and `%`) and FheInt (signed comparisons, arithmetic `>>`, `abs`,
division truncated toward zero) against the JAX package with tolerance 0,
on JAX keys and ciphertexts carried into the port at TEST_TINY, with a
standard key (tests/test_torch_fhe.py runs the multi-bit route); every
result also decrypts to the numpy answer. In one file
because both run the restoring divider, whose JAX gate shapes compile once.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import fhe as JF  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
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


W = 3
XS, YS = np.array([6, 3]), np.array([2, 5])  # FheUint operands (W bits)
SX, SY = np.array([-3, 2]), np.array([2, -4])  # FheInt operands


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
    """TEST_TINY keys with a standard key."""
    return _keys(TEST_TINY, False, 216)


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


def test_fhe_uint_division_matches_jax(bits_keys):
    """`//` and `%` by restoring division, W = 3 bits; a plain divisor too."""
    jsk, jck, psk, pck = bits_keys
    jx = JF.FheUint.encrypt(jax.random.key(224), jsk.lv0, XS, W, jck)
    jy = JF.FheUint.encrypt(jax.random.key(225), jsk.lv0, YS, W, jck)
    x, y = _pair(jx, PF.FheUint, pck), _pair(jy, PF.FheUint, pck)
    cases = [(lambda a, b: a // b, XS // YS), (lambda a, b: a % b, XS % YS), (lambda a, b: a // 3, XS // 3)]
    for op, want in cases:
        _check(op(x, y), op(jx, jy), psk.lv0, want)


def test_fhe_int_matches_jax(bits_keys):
    """Signed comparisons, arithmetic >>, abs, and division truncated toward
    zero, W = 3 bits (two's complement)."""
    jsk, jck, psk, pck = bits_keys
    jx = JF.FheInt.encrypt(jax.random.key(227), jsk.lv0, SX, W, jck)
    jy = JF.FheInt.encrypt(jax.random.key(228), jsk.lv0, SY, W, jck)
    x, y = _pair(jx, PF.FheInt, pck), _pair(jy, PF.FheInt, pck)
    np.testing.assert_array_equal(x.decrypt(psk.lv0), SX)
    quot = np.trunc(SX / SY).astype(np.int64)
    cases = [
        (lambda a, b: a < b, SX < SY), (lambda a, b: a > b, SX > SY), (lambda a, b: a >= b, SX >= SY),
        (lambda a, b: a >> 1, SX >> 1), (lambda a, b: a.abs(), np.abs(SX)),
        (lambda a, b: a // b, quot), (lambda a, b: a % b, SX - quot * SY),
        (lambda a, b: a.sign_bit(), SX < 0),
    ]
    for op, want in cases:
        got = op(x, y)
        assert type(got) is (PF.FheBool if want.dtype == bool else PF.FheInt)
        _check(got, op(jx, jy), psk.lv0, want)
    assert repr(x) == repr(jx) == "FheInt3(batch=(2,))"

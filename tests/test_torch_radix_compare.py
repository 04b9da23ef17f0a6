"""PyTorch port: the comparisons and casts of radix arithmetic
(`models/arithmetic.py`: compare_radix, radix_to_bits, bits_to_radix)
against the JAX package with tolerance 0, on JAX keys carried into the port,
with a standard and with a multi-bit key. tests/test_torch_radix_select.py
holds select_radix, min_radix and max_radix.

Every test runs on the N=512 tiny set of tests/test_mul_radix.py (copied,
not imported): its LUT margins let every function decrypt to the numpy
answer, and with n0 = 16 the JAX side stays cheap. The JAX calls are jitted
(a whole radix operation compiles once, instead of a scan per bootstrap);
their LUT caches are filled eagerly first, since a cache filled inside a
trace would hold tracers. With a multi-bit key, batches of at most 4
ciphertexts take the multi-bit rotation in both packages, so these tests
also pin how each function groups its ciphertexts into bootstrap batches.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic as PA  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool  # noqa: E402
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
_JAX_CACHES = (JA._add_mv, JA._mul_mv, JA._cmp_luts, JA._cmp_mv, JA._sel_luts, JA._cast_luts)


def jax_run(fn, *args):
    """fn(*args) under jax.jit, as numpy (a tuple stays a tuple)."""
    out = jax.jit(fn)(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


@pytest.fixture(scope="module", params=["standard", "multibit"])
def keys(request):
    """(JAX secret key, JAX cloud key, port secret key, port cloud key)."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(190), MP)
    jck = JCloudKey.generate(jax.random.key(191), jsk, multibit=mb)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    for base_bits in (1, 2):
        for fill in _JAX_CACHES:
            fill(base_bits, MP)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PMP, "cpu"), PK.cloud_key_from_numpy(arrays, PMP, "cpu")


def _enc(keys, seed, vals, d, base_bits):
    """JAX-made radix ciphertexts of vals, and the same words in the port."""
    jct = JA.encrypt_radix(jax.random.key(seed), keys[0].lv0, np.asarray(vals), d, MP, base_bits)
    return jct, to_torch(np.asarray(jct), "cpu")


def _same(out, ref):
    np.testing.assert_array_equal(to_numpy(out), ref)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("keys", ["standard"], indirect=True)
@pytest.mark.parametrize("mv", [False, True], ids=["pbs", "multi_value"])
def test_compare_radix_matches_jax(keys, d, mv):
    """The trichotomy tree at depth 0 (D=1), one node (D=2) and a leftover
    node (D=3); equal, greater and less pairs."""
    _compare_case(keys, d, mv, np.array([(1 << (2 * d)) - 1, 2, 5 % (1 << (2 * d))]),
                  np.array([(1 << (2 * d)) - 1, 3 % (1 << (2 * d)), 1]))


@pytest.mark.parametrize("keys", ["multibit"], indirect=True)
def test_compare_radix_multibit_route_matches_jax(keys):
    """One pair at D = 2 with the multi-bit key: the leaf batch of 4 and the
    root's 3 take the multi-bit rotation in both packages (at three pairs
    every batch is above the cap)."""
    _compare_case(keys, 2, False, np.array([9]), np.array([12]))


def _compare_case(keys, d, mv, xs, ys):
    jsk, jck, psk, pck = keys
    ja, pa = _enc(keys, 159 + d, xs, d, 2)
    jb, pb = _enc(keys, 163 + d, ys, d, 2)
    ref = jax_run(lambda a, b, ck: JA.compare_radix(a, b, ck, 2, multi_value=mv), ja, jb, jck)
    out = PA.compare_radix(pa, pb, pck, 2, multi_value=mv)
    for o, r in zip(out, ref):
        _same(o, r)
    for o, want in zip(out, (xs == ys, xs > ys, xs < ys)):
        np.testing.assert_array_equal(lwe_decrypt_bool(o, psk.lv0).numpy(), want)


@pytest.mark.parametrize("keys", ["standard"], indirect=True)
def test_radix_bits_casts_match_jax(keys):
    """radix_to_bits, and bits_to_radix of its output (a top digit with a
    missing bit: W = 5 bits into 3 base-4 digits); every batch is above the
    multi-bit cap, so the standard key."""
    jsk, jck, psk, pck = keys
    xs = np.array([45, 18])
    ja, pa = _enc(keys, 175, xs, 3, 2)

    def ops(a, ck):
        bits = JA.radix_to_bits(a, ck, 2)
        return bits, JA.bits_to_radix(bits[..., :5, :], ck, 2, num_digits=3)

    ref = jax_run(ops, ja, jck)
    bits = PA.radix_to_bits(pa, pck, 2)
    back = PA.bits_to_radix(bits[..., :5, :], pck, 2, num_digits=3)
    _same(bits, ref[0])
    _same(back, ref[1])
    got = lwe_decrypt_bool(bits, psk.lv0).numpy()
    np.testing.assert_array_equal(got, (xs[:, None] >> np.arange(6)) & 1)
    np.testing.assert_array_equal(PA.decrypt_radix(back, psk.lv0, 2), xs % 32)
    with pytest.raises(ValueError):
        PA.bits_to_radix(bits, pck, 2, num_digits=2)

"""PyTorch port: selection over radix digit vectors (`models/arithmetic.py`:
select_radix, min_radix, max_radix) against the JAX package with tolerance
0, on JAX keys carried into the port, with a standard and with a multi-bit
key.

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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic as PA  # noqa: E402
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
_JAX_CACHES = (JA._add_mv, JA._mul_mv, JA._cmp_luts, JA._cmp_mv, JA._sel_luts, JA._cast_luts)


def jax_run(fn, *args):
    """fn(*args) under jax.jit, as numpy (a tuple stays a tuple)."""
    out = jax.jit(fn)(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


@pytest.fixture(scope="module", params=["standard", "multibit"])
def keys(request):
    """(JAX secret key, JAX cloud key, port secret key, port cloud key)."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(195), MP)
    jck = JCloudKey.generate(jax.random.key(196), jsk, multibit=mb)
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


def test_select_radix_matches_jax(keys):
    """select_radix with and without the refresh, on one digit: with the
    multi-bit key every batch (2, 4, 2) takes the multi-bit rotation."""
    jsk, jck, psk, pck = keys
    xs, ys, sels = np.array([3, 1]), np.array([2, 3]), np.array([True, False])
    ja, pa = _enc(keys, 170, xs, 1, 2)
    jb, pb = _enc(keys, 171, ys, 1, 2)
    jsel = JT.lwe_encrypt_bool(jax.random.key(172), jsk.lv0, jnp.asarray(sels), MP.tlwe_lv0.alpha)
    psel = to_torch(np.asarray(jsel), "cpu")
    ref = jax_run(lambda sel, a, b, ck: (JA.select_radix(sel, a, b, ck, 2),
                                         JA.select_radix(sel, a, b, ck, 2, refresh=False)), jsel, ja, jb, jck)
    out = (PA.select_radix(psel, pa, pb, pck, 2), PA.select_radix(psel, pa, pb, pck, 2, refresh=False))
    for o, r in zip(out, ref):
        _same(o, r)
        np.testing.assert_array_equal(PA.decrypt_radix(o, psk.lv0, 2), np.where(sels, xs, ys))


@pytest.mark.parametrize("keys", ["standard"], indirect=True)
def test_min_max_radix_match_jax(keys):
    """min_radix, and max_radix through the multi-value comparator."""
    jsk, jck, psk, pck = keys
    xs, ys = np.array([13, 2]), np.array([4, 9])
    ja, pa = _enc(keys, 173, xs, 2, 2)
    jb, pb = _enc(keys, 174, ys, 2, 2)
    ref = jax_run(lambda a, b, ck: (JA.min_radix(a, b, ck, 2), JA.max_radix(a, b, ck, 2, multi_value=True)),
                  ja, jb, jck)
    out = (PA.min_radix(pa, pb, pck, 2), PA.max_radix(pa, pb, pck, 2, multi_value=True))
    for o, r, want in zip(out, ref, (np.minimum(xs, ys), np.maximum(xs, ys))):
        _same(o, r)
        np.testing.assert_array_equal(PA.decrypt_radix(o, psk.lv0, 2), want)

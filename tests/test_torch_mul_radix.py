"""PyTorch port: mul_radix (`models/arithmetic.py`) against the JAX package
with tolerance 0, on JAX keys carried into the port, with a standard and
with a multi-bit key: D = 2 without and D = 3 with a normalization round,
each with and without multi-value bootstrapping.

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


def jax_run(fn, *args):
    """fn(*args) under jax.jit, as numpy (a tuple stays a tuple)."""
    out = jax.jit(fn)(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


@pytest.fixture(scope="module", params=["standard", "multibit"])
def keys(request):
    """(JAX secret key, JAX cloud key, port secret key, port cloud key)."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(160), MP)
    jck = JCloudKey.generate(jax.random.key(161), jsk, multibit=mb)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    for base_bits in (1, 2):
        JA._mul_mv(base_bits, MP)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PMP, "cpu"), PK.cloud_key_from_numpy(arrays, PMP, "cpu")


def _enc(keys, seed, vals, d, base_bits):
    """JAX-made radix ciphertexts of vals, and the same words in the port."""
    jct = JA.encrypt_radix(jax.random.key(seed), keys[0].lv0, np.asarray(vals), d, MP, base_bits)
    return jct, to_torch(np.asarray(jct), "cpu")


def _same(out, ref):
    np.testing.assert_array_equal(to_numpy(out), ref)


# ---------------------------------------------------------------------------
# mul_radix, bit for bit and decrypted
# ---------------------------------------------------------------------------

def _mul_case(keys, mv, d, base_bits, xs, ys):
    jsk, jck, psk, pck = keys
    ja, pa = _enc(keys, 157, xs, d, base_bits)
    jb, pb = _enc(keys, 158, ys, d, base_bits)
    ref = jax_run(lambda a, b, ck: JA.mul_radix(a, b, ck, base_bits, multi_value=mv), ja, jb, jck)
    out = PA.mul_radix(pa, pb, pck, base_bits, multi_value=mv)
    assert out.shape[-2] == 2 * d
    _same(out, ref)
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, base_bits), xs * ys)


@pytest.mark.parametrize(
    "keys, mv", [("standard", False), ("multibit", True)], indirect=["keys"],
    ids=["standard-pbs", "multibit-multi_value"],
)
def test_mul_radix_matches_jax(keys, mv):
    """D = 2 at base 4: no normalization round. Multi-value factors only the
    pair stage; the other stages' small batches take the multi-bit rotation."""
    _mul_case(keys, mv, 2, 2, np.array([15, 6]), np.array([15, 11]))


@pytest.mark.parametrize("keys", ["standard"], indirect=True)
@pytest.mark.parametrize("mv", [False, True], ids=["pbs", "multi_value"])
def test_mul_radix_normalization_matches_jax(keys, mv):
    """D = 3 at base 2: column 3's worst case exceeds the modulus-8 range, so
    it takes a normalization round."""
    assert max(PA._col_bounds(3, 2)) >= 8
    _mul_case(keys, mv, 3, 1, np.array([7]), np.array([7]))

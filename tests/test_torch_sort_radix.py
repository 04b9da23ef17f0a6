"""PyTorch port: the bitonic sorting networks (`models/sort.py`) against the
JAX package with tolerance 0, on JAX keys carried into the port.

sort_radix runs the radix comparator and select on the N=512 tiny set of
tests/test_mul_radix.py (copied), which gives them their margins, with a
multi-bit key (its batches of 4 and fewer take the multi-bit rotation);
JAX's under jax.jit with its LUT caches filled first. K = 3 (padded to 4
with trivial MAX sentinels) ascending with the multi-value comparator, and
K = 4 descending. tests/test_torch_sort.py holds the gate networks.
Every result decrypts to the sorted numpy values, and the inputs are
unchanged after the call.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.models import sort as JS  # noqa: E402
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic as PA  # noqa: E402
from rs_tfhe_tpu_torch.models import sort as PS  # noqa: E402
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
BASE_BITS = 2


def _keys(params, seed, multibit):
    jsk = JSecretKey.generate(jax.random.key(seed), params)
    jck = JCloudKey.generate(jax.random.key(seed + 1), jsk, multibit=multibit)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if multibit:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    pp = params_from(params)
    return jsk, jck, PK.secret_key_from_numpy(arrays, pp, "cpu"), PK.cloud_key_from_numpy(arrays, pp, "cpu")


@pytest.fixture(scope="module")
def radix_keys():
    """N=512 keys for the radix network, a multi-bit key: its batches of 4
    and fewer take the multi-bit rotation, the rest the standard one."""
    for fill in (JA._cmp_luts, JA._cmp_mv, JA._sel_luts):
        fill(BASE_BITS, MP)
    return _keys(MP, 203, True)


@pytest.mark.parametrize(
    "vals, descending, mv", [([1, 3, 2], False, True), ([3, 0, 2, 3], True, False)],
    ids=["k3_asc_mv", "k4_desc"],
)
def test_sort_radix_matches_jax(radix_keys, vals, descending, mv):
    """One base-4 digit; the K=3 case pads with a trivial 3 (the largest
    value, so it sorts past the ties)."""
    jsk, jck, psk, pck = radix_keys
    jx = JA.encrypt_radix(jax.random.key(207), jsk.lv0, np.asarray(vals), 1, MP, BASE_BITS)
    px = to_torch(np.asarray(jx), "cpu")
    before = px.clone()
    ref = np.asarray(jax.jit(
        lambda x, ck: JS.sort_radix(x, ck, BASE_BITS, descending=descending, multi_value=mv))(jx, jck))
    out = PS.sort_radix(px, pck, BASE_BITS, descending=descending, multi_value=mv)
    np.testing.assert_array_equal(to_numpy(out), ref)
    assert torch.equal(px, before)
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, BASE_BITS), sorted(vals, reverse=descending))

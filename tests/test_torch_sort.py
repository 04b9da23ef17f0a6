"""PyTorch port: the bitonic sorting networks (`models/sort.py`) against the
JAX package with tolerance 0, on JAX keys carried into the port.

sort_bits and top_k_bits (JAX's top_k_bits is its sort_bits, sliced) run
the gate circuits at TEST_TINY with a standard key, JAX's eagerly (its
gates are jitted, so the network's repeated shapes compile once). K = 3
(padded to 4 with trivial MAX sentinels) and K = 4, ascending and
descending. tests/test_torch_sort_radix.py holds sort_radix.
Every result decrypts to the sorted numpy values, and the inputs are
unchanged after the call.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import bit_utils as JBU  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import sort as JS  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch import bit_utils  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
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


W = 3


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
def keys():
    """TEST_TINY keys for the gate networks, a standard key."""
    return _keys(TEST_TINY, 200, False)


def test_bitonic_schedule_matches_jax():
    for k in (1, 2, 4, 8, 16):
        for (plo, phi, pdesc), (jlo, jhi, jdesc) in zip(PS._bitonic_schedule(k), JS._bitonic_schedule(k), strict=True):
            np.testing.assert_array_equal(plo, jlo)
            np.testing.assert_array_equal(phi, jhi)
            np.testing.assert_array_equal(pdesc, jdesc)
    assert [PS._next_pow2(k) for k in range(1, 18)] == [JS._next_pow2(k) for k in range(1, 18)]
    with pytest.raises(ValueError):
        PS._bitonic_schedule(6)


def _bits_input(keys, vals, seed):
    jsk = keys[0]
    jx = jnp.stack([JBU.encrypt_uint(jax.random.key(seed + i), jsk.lv0, int(v), W, TEST_TINY.tlwe_lv0.alpha)
                    for i, v in enumerate(vals)])
    return jx, to_torch(np.asarray(jx), "cpu")


@pytest.mark.parametrize("vals, descending", [([5, 0, 7], True), ([6, 3, 6, 1], False)], ids=["k3_desc", "k4_asc"])
def test_sort_bits_matches_jax(keys, vals, descending):
    jsk, jck, psk, pck = keys
    jx, px = _bits_input(keys, vals, 202)
    before = px.clone()
    ref = np.asarray(JS.sort_bits(jx, jck, descending=descending))
    out = PS.sort_bits(px, pck, descending=descending)
    np.testing.assert_array_equal(to_numpy(out), ref)
    assert torch.equal(px, before)
    assert [bit_utils.decrypt_uint(row, psk.lv0) for row in out] == sorted(vals, reverse=descending)
    if descending:  # JAX's top_k_bits(x, k, largest=True) is sort_bits(x, descending=True)[:k]
        np.testing.assert_array_equal(to_numpy(PS.top_k_bits(px, 2, pck)), ref[:2])
    else:
        np.testing.assert_array_equal(to_numpy(PS.top_k_bits(px, 2, pck, largest=False)), ref[:2])


def test_sort_of_one_is_the_input(keys):
    px = torch.zeros((1, 2, TEST_TINY.n0 + 1), dtype=torch.int32)
    assert PS.sort_radix(px, keys[3]) is px and PS.sort_bits(px, keys[3]) is px

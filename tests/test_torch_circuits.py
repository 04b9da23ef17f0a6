"""PyTorch port: `bit_utils` and the boolean circuits of `models/circuits.py`
against the JAX package, bit for bit (tolerance 0: all arithmetic is exact
mod 2^32), on one JAX key at TEST_TINY carried into the port and on JAX-made
ciphertexts; every result also decrypts to the integer it should be. And the
port's entry points never land on the CPU unasked."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import bit_utils as JBU  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import circuits as JC  # noqa: E402
from rs_tfhe_tpu_torch import bit_utils as PBU  # noqa: E402
from rs_tfhe_tpu_torch import gates as PGa  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch.models import circuits as PC  # noqa: E402
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


TINY, PTINY = JP.TEST_TINY, params_from(JP.TEST_TINY)
W = 4
X, Y = 11, 6


@pytest.fixture(scope="module")
def keys():
    """A JAX key at TEST_TINY, the same key in the port, and an encryptor of
    integers that returns the JAX ciphertext and its copy in the port."""
    jsk = JSecretKey.generate(jax.random.key(81), TINY)
    jck = JCloudKey.generate(jax.random.key(82), jsk)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    psk = PK.secret_key_from_numpy(arrays, PTINY, "cpu")
    pck = PK.cloud_key_from_numpy(arrays, PTINY, "cpu")

    def enc(val, seed, width=W):
        ct = JBU.encrypt_uint(jax.random.key(seed), jsk.lv0, val, width, TINY.tlwe_lv0.alpha)
        return ct, to_torch(np.asarray(ct), "cpu")

    return jsk, jck, psk, pck, enc


def _same(port, ref):
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


CASES = {
    "add_kogge_stone": lambda x, y: (x + y) % 16,
    "add_ripple_carry": lambda x, y: (x + y) % 16,
    "sub": lambda x, y: (x - y) % 16,
    "mul_csa": lambda x, y: (x * y) % 16,
    "equals": lambda x, y: int(x == y),
    "greater_than": lambda x, y: int(x > y),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("x,y", [(X, Y), (Y, Y)], ids=["11_6", "6_6"])
def test_circuit_matches_jax_and_decrypts(keys, name, x, y):
    jsk, jck, psk, pck, enc = keys
    (ja, pa), (jb, pb) = enc(x, 83), enc(y, 84)
    ref = getattr(JC, name)(ja, jb, jck)
    out = getattr(PC, name)(pa, pb, pck)
    _same(out, ref)
    if out.dim() == 1:  # the comparators return one ciphertext
        out = out[None]
    assert PBU.decrypt_uint(out, psk.lv0) == CASES[name](x, y)


def test_divmod_bits_matches_jax_and_decrypts(keys):
    jsk, jck, psk, pck, enc = keys
    (jn, pn), (jd, pd) = enc(7, 85, 3), enc(3, 86, 3)
    jq, jr = JC.divmod_bits(jn, jd, jck)
    q, r = PC.divmod_bits(pn, pd, pck)
    _same(q, jq)
    _same(r, jr)
    assert (PBU.decrypt_uint(q, psk.lv0), PBU.decrypt_uint(r, psk.lv0)) == (2, 1)


@pytest.mark.parametrize("name", ["add_kogge_stone", "mul_csa", "equals"])
def test_circuits_take_leading_batch_dims(keys, name):
    """A [2, W, n0+1] batch of pairs is one gate batch per round."""
    jsk, jck, psk, pck, enc = keys
    pairs = [(X, Y), (5, 13)]
    ja, pa = zip(*(enc(x, 87 + i) for i, (x, _) in enumerate(pairs)))
    jb, pb = zip(*(enc(y, 90 + i) for i, (_, y) in enumerate(pairs)))
    ref = getattr(JC, name)(jnp.stack(ja), jnp.stack(jb), jck)
    out = getattr(PC, name)(torch.stack(pa), torch.stack(pb), pck)
    _same(out, ref)
    for row, (x, y) in zip(out, pairs):
        assert PBU.decrypt_uint(row if row.dim() == 2 else row[None], psk.lv0) == CASES[name](x, y)


def test_shift_up_matches_jax(keys):
    _, _, _, _, enc = keys
    ja, pa = enc(X, 93)
    fill = np.asarray(np.random.default_rng(94).integers(0, 1 << 32, TINY.n0 + 1, dtype=np.uint32))
    for k in (1, 3):
        _same(PC._shift_up(pa, k, to_torch(fill, "cpu")), JC._shift_up(ja, k, jnp.asarray(fill)))


@pytest.mark.parametrize("val,size", [(0, 1), (11, 4), (0xDEADBEEF, 32), (5, 8)])
def test_bits_match_jax(val, size):
    np.testing.assert_array_equal(PBU.to_bits(val, size), JBU.to_bits(val, size))
    assert PBU.from_bits(PBU.to_bits(val, size)) == JBU.from_bits(JBU.to_bits(val, size)) == val % (1 << size)


def test_encrypt_and_decrypt_uint(keys):
    """The port decrypts a JAX encryption as JAX does, and its own
    encryption (its own generator) round-trips."""
    jsk, _, psk, _, enc = keys
    jct, pct = enc(0xA5, 95, 8)
    assert PBU.decrypt_uint(pct, psk.lv0) == JBU.decrypt_uint(jct, jsk.lv0) == 0xA5
    g = torch.Generator().manual_seed(96)
    ct = PBU.encrypt_uint(g, psk.lv0, 0x3C5A, 16, PTINY.tlwe_lv0.alpha)
    assert tuple(ct.shape) == (16, PTINY.n0 + 1) and ct.dtype == torch.int32
    assert PBU.decrypt_uint(ct, psk.lv0) == 0x3C5A


NO_DEVICE = {
    "gates.constant": lambda dev: PGa.constant(True, 2, PTINY, **dev),
    "tlwe.lwe_trivial_message": lambda dev: PT.lwe_trivial_message([1, 2], 4, PTINY.n0, **dev),
    "tlwe.lwe_trivial_bool": lambda dev: PT.lwe_trivial_bool([True], PTINY.n0, **dev),
    "key.gen_testvec": lambda dev: PK.gen_testvec(PTINY, **dev),
    "torus.to_torch": lambda dev: PTo.to_torch(np.zeros(3, np.uint32), **dev),
    "key.secret_key_from_numpy": lambda dev: PK.secret_key_from_numpy(
        {"lv0": np.zeros(PTINY.n0, np.uint32), "lv1": np.zeros(PTINY.n1, np.uint32)}, PTINY, **dev).lv0,
}


@pytest.mark.parametrize("name", list(NO_DEVICE))
def test_no_entry_point_lands_on_the_cpu_unasked(name):
    """Given no device, an entry point makes its tensors on the card, or
    raises where there is none; it returns a CPU tensor only when asked."""
    if torch.cuda.is_available():
        assert NO_DEVICE[name]({}).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NO_DEVICE[name]({})
    assert NO_DEVICE[name]({"device": "cpu"}).device.type == "cpu"


def test_cloud_key_from_numpy_never_defaults_to_the_cpu(keys):
    _, jck, _, _, _ = keys
    arrays = {"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if torch.cuda.is_available():
        assert PK.cloud_key_from_numpy(arrays, PTINY).bsk.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PK.cloud_key_from_numpy(arrays, PTINY)
    assert PTo.resolve_device("cpu") == torch.device("cpu")

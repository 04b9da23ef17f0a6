"""PyTorch port: multi-value programmable bootstrapping
(`lut/multi_value.py`) against the JAX package with tolerance 0:
`factor_test_vectors` (terms, norms, tv0 and its refusals), `_mul_sparse`,
`sample_extract` on the extra LUT axis, and `multi_value_bootstrap` on JAX
keys at TEST_TINY carried into the port, with a standard and with a
multi-bit key (both packages rotate with the standard key here)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import lut as JL  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.lut import multi_value as JMV  # noqa: E402
from rs_tfhe_tpu.ops.extract import sample_extract as j_sample_extract  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import lut as PL  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.bootstrap import bootstrap_with_testvec  # noqa: E402
from rs_tfhe_tpu_torch.lut import multi_value as PMV  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
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
MODULUS = 4
FAMILIES = {
    "two_luts": (lambda v: (v + 1) % MODULUS, lambda v: (3 * v) % MODULUS),
    "three_luts": (lambda v: v, lambda v: (v * v) % MODULUS, lambda v: (v + 2) % MODULUS),
    "one_lut": (lambda v: (2 * v + 1) % MODULUS,),
}


def _polys(fs, modulus=MODULUS):
    jgen, pgen = JL.Generator(modulus, TINY), PL.Generator(modulus, PTINY)
    return ([jgen.generate_lookup_table(f).poly for f in fs], [pgen.generate_lookup_table(f).poly for f in fs])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_factor_test_vectors_matches_jax(family):
    jpolys, ppolys = _polys(FAMILIES[family])
    ref, mv = JMV.factor_test_vectors(jpolys), PMV.factor_test_vectors(ppolys)
    assert mv.terms == ref.terms
    assert mv.norms == ref.norms
    assert mv.n_luts == ref.n_luts == len(FAMILIES[family])
    np.testing.assert_array_equal(to_numpy(mv.tv0), np.asarray(ref.tv0))
    assert all(0 <= c < 1 << 32 for t in mv.terms for _, c in t)


def test_factor_test_vectors_includes_the_gate_test_vector():
    """CloudKey.testvec (constant 1/8) factors with the LUTs, as in JAX."""
    jpolys, ppolys = _polys(FAMILIES["two_luts"])
    jtv, ptv = jnp.asarray(np.asarray(PK.gen_testvec(PTINY, "cpu")).view(np.uint32)), PK.gen_testvec(PTINY, "cpu")
    ref, mv = JMV.factor_test_vectors([*jpolys, jtv]), PMV.factor_test_vectors([*ppolys, ptv])
    assert (mv.terms, mv.norms) == (ref.terms, ref.norms)


def _tv(values):
    return np.stack([np.zeros(len(values), np.uint32), np.asarray(values, np.uint32)])


REFUSED = {
    "odd_gcd": [_tv([3] * 8 + [6] * 8)],
    "constant_zero": [_tv([0] * 16)],
    "mask_row": [np.ones((2, 16), np.uint32)],
    "shape": [_tv([2] * 16), _tv([2] * 8)],
    "empty": [],
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_factor_test_vectors_refuses_what_jax_refuses(name):
    with pytest.raises(ValueError) as jerr:
        JMV.factor_test_vectors([jnp.asarray(m) for m in REFUSED[name]])
    with pytest.raises(ValueError) as perr:
        PMV.factor_test_vectors([to_torch(m, "cpu") for m in REFUSED[name]])
    assert str(perr.value) == str(jerr.value)
    if name == "odd_gcd":
        assert "odd" in str(perr.value)


def test_mul_sparse_matches_jax():
    rng = np.random.default_rng(121)
    acc = rng.integers(0, 1 << 32, (3, 2, 32), dtype=np.uint32)
    for terms in (((0, 5), (7, (1 << 32) - 3), (31, 1 << 31)), ((4, 2),), ()):
        ref = JMV._mul_sparse(jnp.asarray(acc), terms)
        np.testing.assert_array_equal(to_numpy(PMV._mul_sparse(to_torch(acc, "cpu"), terms)), np.asarray(ref))


def test_sample_extract_takes_the_lut_axis():
    acc = np.random.default_rng(122).integers(0, 1 << 32, (3, 2, 2, 16), dtype=np.uint32)
    np.testing.assert_array_equal(
        to_numpy(sample_extract(to_torch(acc, "cpu"))), np.asarray(j_sample_extract(jnp.asarray(acc))))


@pytest.fixture(scope="module", params=[False, True], ids=["standard_key", "multibit_key"])
def keys(request):
    jsk = JSecretKey.generate(jax.random.key(123), TINY)
    jck = JCloudKey.generate(jax.random.key(124), jsk, multibit=request.param)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if request.param:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")


@pytest.mark.parametrize("lead", [(4,), (2, 2)], ids=["flat", "leading_dims"])
def test_multi_value_bootstrap_matches_jax(keys, lead):
    """Bit for bit against JAX; each output decrypts to its LUT's value and
    to what the dedicated bootstrap_with_testvec gives."""
    jsk, jck, psk, pck = keys
    fs = FAMILIES["two_luts"]
    jpolys, ppolys = _polys(fs)
    msgs = np.arange(MODULUS).reshape(lead)
    jct = JT.lwe_encrypt_message(jax.random.key(125), jsk.lv0, jnp.asarray(msgs), MODULUS, TINY.tlwe_lv0.alpha)
    ref = JMV.multi_value_bootstrap(jct, JMV.factor_test_vectors(jpolys), jck)
    pct = to_torch(np.asarray(jct), "cpu")
    out = PL.multi_value_bootstrap(pct, PL.factor_test_vectors(ppolys), pck)
    assert tuple(out.shape) == (*lead, len(fs), PTINY.n0 + 1)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(ref))
    for k, f in enumerate(fs):
        got = PT.lwe_decrypt_message(out[..., k, :], psk.lv0, MODULUS)
        np.testing.assert_array_equal(got, f(msgs))
        dedicated = bootstrap_with_testvec(pct, ppolys[k], pck)
        np.testing.assert_array_equal(got, PT.lwe_decrypt_message(dedicated, psk.lv0, MODULUS))

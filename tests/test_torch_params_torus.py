"""PyTorch port: parameter sets, torus helpers, LWE encryption statistics and
the linear operators, held against the JAX package (bit-exact unless a test
says it checks a distribution)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
import rs_tfhe_tpu.tlwe as JT  # noqa: E402
import rs_tfhe_tpu.torus as JTo  # noqa: E402
import rs_tfhe_tpu_torch.params as PP  # noqa: E402
import rs_tfhe_tpu_torch.tlwe as PT  # noqa: E402
import rs_tfhe_tpu_torch.torus as PTo  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_DERIVED = (
    "n0", "n1", "ks_base", "ksk_alpha", "bsk_alpha", "decomposition_offset",
    "decomposition_round_bit", "digit_limbs",
)
_SET_NAMES = sorted(JP.ALL_SECURITY_SETS) + ["TEST_TINY"]
_EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF], dtype=np.uint32)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


@pytest.mark.parametrize("name", _SET_NAMES)
def test_params_match_reference(name):
    ref = getattr(JP, name)
    port = getattr(PP, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in _DERIVED:
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.trgsw_lv1.bg == ref.trgsw_lv1.bg
    assert port.trgsw_lv1.half_bg == ref.trgsw_lv1.half_bg
    assert PP.security_info(port) == JP.security_info(ref)
    assert PP.params_from(ref) == port


def test_security_set_registry_matches():
    assert list(PP.ALL_SECURITY_SETS) == list(JP.ALL_SECURITY_SETS)
    assert PP.DEFAULT_SECURITY == PP.params_from(JP.DEFAULT_SECURITY)
    assert PP.TORUS_BITS == JP.TORUS_BITS


def test_torus_conversions_and_negation():
    rng = np.random.default_rng(1)
    x = np.concatenate([_EDGES, _u32(rng, 58)])
    d = rng.normal(size=64) * 3
    np.testing.assert_array_equal(PTo.f64_to_torus(d), JTo.f64_to_torus(d))
    np.testing.assert_array_equal(PTo.torus_to_f64(x), JTo.torus_to_f64(x))
    t = PTo.to_torch(x, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(PTo.to_numpy(t), x)
    np.testing.assert_array_equal(
        PTo.to_numpy(PTo.neg_torus(t)), np.asarray(JTo.neg_torus(jnp.asarray(x)))
    )
    for s in (0, 1, 7, 21, 31):
        np.testing.assert_array_equal(PTo.to_numpy(PTo.logical_rshift(t, s)), x >> np.uint32(s))
    assert [PTo.i32(v) for v in (0, 2**31, 2**32 - 1, -1, 2**32 + 5)] == [0, -(2**31), -1, -1, 5]


def test_planar_limbs_match_reference():
    rng = np.random.default_rng(2)
    x = np.concatenate([_EDGES, _u32(rng, 3 * 64 - len(_EDGES))]).reshape(3, 64)
    port = PTo.split_u32_limbs_planar(PTo.to_torch(x, "cpu"))
    ref = np.asarray(JTo.split_u32_limbs_planar(jnp.asarray(x)))
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(PTo.to_numpy(PTo.recombine_planar(port)), x)
    acc = rng.integers(-(2**20), 2**20, (5, 4, 32)).astype(np.int32)
    np.testing.assert_array_equal(
        PTo.to_numpy(PTo.recombine_planar(torch.from_numpy(acc))),
        np.asarray(JTo.recombine_planar(jnp.asarray(acc))),
    )


def test_lwe_encrypt_phase_error_std():
    """The phase error of a fresh encryption is the gaussian noise: std within
    10% of alpha * 2^32 over 4096 samples (SECURITY_128_BIT lv0 alpha, where
    the truncation toward zero is negligible), mean near 0."""
    p = PP.SECURITY_128_BIT
    g = torch.Generator().manual_seed(5)
    s = torch.randint(0, 2, (p.n0,), generator=g, dtype=torch.int32)
    mu = torch.full((4096,), PTo.i32(int(PTo.f64_to_torus(0.125))), dtype=torch.int32)
    ct = PT.lwe_encrypt_torus(g, s, mu, p.tlwe_lv0.alpha)
    err = (PT.lwe_phase(ct, s) - mu).double()
    sigma = p.tlwe_lv0.alpha * 2.0**32
    assert abs(err.std().item() / sigma - 1) < 0.10
    assert abs(err.mean().item()) < 4 * sigma / 64
    # decryption agrees with the reference on the same ciphertexts
    np.testing.assert_array_equal(
        PT.lwe_decrypt_bool(ct, s).numpy(),
        np.asarray(JT.lwe_decrypt_bool(jnp.asarray(PTo.to_numpy(ct)), jnp.asarray(PTo.to_numpy(s)))),
    )


def test_mask_bytes_uniform():
    """Each byte of the uniform mask words is uniform over 256 values
    (chi-square, 255 degrees of freedom, far tail threshold)."""
    g = torch.Generator().manual_seed(6)
    s = torch.randint(0, 2, (64,), generator=g, dtype=torch.int32)
    ct = PT.lwe_encrypt_bool(g, s, torch.ones(4096, dtype=torch.bool), 1e-9)
    words = PTo.to_numpy(ct[:, :-1]).ravel()
    expect = words.size / 256
    for byte in range(4):
        counts = np.bincount((words >> np.uint32(8 * byte)) & np.uint32(255), minlength=256)
        chi2 = ((counts - expect) ** 2 / expect).sum()
        assert chi2 < 400, (byte, chi2)


@pytest.mark.parametrize(
    "op", ["add", "sub", "neg", "mul", "add_mul", "sub_mul", "add_bias", "trivial_bool"]
)
def test_lwe_linear_ops_match_reference(op):
    rng = np.random.default_rng(3)
    x = np.concatenate([_EDGES, _u32(rng, 2)]).reshape(8, 1) + np.zeros((1, 5), np.uint32)
    y = _u32(rng, (8, 5))
    y[:, 0] = 0xFFFFFFFF
    px, py = PTo.to_torch(x, "cpu"), PTo.to_torch(y, "cpu")
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    bits = np.array([True, False] * 4)
    port, ref = {
        "add": (lambda: PT.lwe_add(px, py), lambda: JT.lwe_add(jx, jy)),
        "sub": (lambda: PT.lwe_sub(px, py), lambda: JT.lwe_sub(jx, jy)),
        "neg": (lambda: PT.lwe_neg(px), lambda: JT.lwe_neg(jx)),
        "mul": (lambda: PT.lwe_mul(px, -3), lambda: JT.lwe_mul(jx, -3)),
        "add_mul": (lambda: PT.lwe_add_mul(px, py, 5), lambda: JT.lwe_add_mul(jx, jy, 5)),
        "sub_mul": (lambda: PT.lwe_sub_mul(px, py, 7), lambda: JT.lwe_sub_mul(jx, jy, 7)),
        "add_bias": (
            lambda: PT.lwe_add_bias(px, 0xE0000000), lambda: JT.lwe_add_bias(jx, 0xE0000000)
        ),
        "trivial_bool": (
            lambda: PT.lwe_trivial_bool(bits, 4, "cpu"), lambda: JT.lwe_trivial_bool(bits, 4)
        ),
    }[op]
    np.testing.assert_array_equal(PTo.to_numpy(port()), np.asarray(ref()))


def test_lwe_decrypt_matches_reference_on_reference_ciphertexts():
    p = JP.TEST_TINY
    key = jax.random.key(9)
    s = jax.random.bernoulli(key, 0.5, (p.n0,)).astype(jnp.uint32)
    m = jnp.asarray(np.random.default_rng(4).integers(0, 2, 64).astype(bool))
    ct = JT.lwe_encrypt_bool(jax.random.key(10), s, m, p.tlwe_lv0.alpha)
    port = PT.lwe_decrypt_bool(PTo.to_torch(np.asarray(ct), "cpu"), PTo.to_torch(np.asarray(s), "cpu"))
    np.testing.assert_array_equal(port.numpy(), np.asarray(m))
    np.testing.assert_array_equal(
        PTo.to_numpy(PT.lwe_phase(PTo.to_torch(np.asarray(ct), "cpu"), PTo.to_torch(np.asarray(s), "cpu"))),
        np.asarray(JT.lwe_phase(ct, s)),
    )

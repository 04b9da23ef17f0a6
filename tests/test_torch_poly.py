"""PyTorch port: polynomial arithmetic, gadget decomposition, modulus
switching, sample extraction and the TRLWE/TRGSW layer, held bit-exact
(tolerance 0) against the JAX package on the same inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import trgsw as JG  # noqa: E402
from rs_tfhe_tpu import trlwe as JR  # noqa: E402
from rs_tfhe_tpu.ops import blind_rotate as JBR  # noqa: E402
from rs_tfhe_tpu.ops import decompose as JD  # noqa: E402
from rs_tfhe_tpu.ops import extract as JE  # noqa: E402
from rs_tfhe_tpu.ops import poly as JPo  # noqa: E402
from rs_tfhe_tpu_torch import trgsw as PG  # noqa: E402
from rs_tfhe_tpu_torch import trlwe as PR  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import decompose as PD  # noqa: E402
from rs_tfhe_tpu_torch.ops import extract as PE  # noqa: E402
from rs_tfhe_tpu_torch.ops import poly as PPo  # noqa: E402
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


TINY = JP.TEST_TINY
_EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF], dtype=np.uint32)


def _u32(rng, shape):
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    flat[: len(_EDGES)] = _EDGES[: flat.size]
    return x


def _eq(port, ref):
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


def test_negacyclic_extend_matches():
    t = _u32(np.random.default_rng(0), (3, 2, 64))
    _eq(PPo.negacyclic_extend(to_torch(t, "cpu")), JPo.negacyclic_extend(jnp.asarray(t)))


def test_monomial_rotate_every_exponent():
    """k spans [0, 2N), so k >= N (the negated half-turn) is covered, and
    the exponents are per row as in blind rotation."""
    n = 64
    t = _u32(np.random.default_rng(1), (2 * n, 2, n))
    k = np.arange(2 * n, dtype=np.int32)
    port = PPo.monomial_rotate(to_torch(t, "cpu"), torch.from_numpy(k)[:, None])
    ref = JPo.monomial_rotate(jnp.asarray(t), jnp.asarray(k)[:, None])
    _eq(port, ref)
    _eq(PPo.monomial_rotate(to_torch(t[0], "cpu"), 3 * n + 5), JPo.monomial_rotate(jnp.asarray(t[0]), 3 * n + 5))


def test_polymul_torus_by_binary_matches():
    rng = np.random.default_rng(2)
    a = _u32(rng, (5, 64))
    s = rng.integers(0, 2, 64).astype(np.uint32)
    _eq(
        PPo.polymul_torus_by_binary(to_torch(a, "cpu"), to_torch(s, "cpu")),
        JPo.polymul_torus_by_binary(jnp.asarray(a), jnp.asarray(s)),
    )


def test_polymul_small_by_torus_matches_schoolbook():
    rng = np.random.default_rng(3)
    d = rng.integers(-128, 128, (2, 4, 64)).astype(np.int32)
    t = _u32(rng, (4, 2, 64))
    port = to_numpy(PPo.polymul_small_by_torus(torch.from_numpy(d), to_torch(t, "cpu"), 128))
    for b in range(2):
        for o in range(2):
            ref = np.zeros(64, np.uint32)
            for j in range(4):
                with np.errstate(over="ignore"):
                    ref += JPo.schoolbook_negacyclic(d[b, j].astype(np.uint32), t[j, o])
            np.testing.assert_array_equal(port[b, o], ref)


def test_float64_bound_is_enforced():
    """Digit sets whose float64 sums against whole words could pass 2^53
    (SECURITY_UINT2: bgbit=18) take the split 16-bit product and stay exact;
    digits beyond even the split product's bound are refused instead of
    rounded silently."""
    p = params_from(JP.SECURITY_UINT2)
    j, n = 2 * p.trgsw_lv1.l, p.n1
    rng = np.random.default_rng(10)
    d = rng.integers(-p.trgsw_lv1.half_bg, p.trgsw_lv1.half_bg, (1, j, n)).astype(np.int32)
    t = _u32(rng, (j, 2, n))
    port = PPo.polymul_small_by_torus(torch.from_numpy(d), to_torch(t, "cpu"), p.trgsw_lv1.half_bg)
    ref = JPo.polymul_small_by_torus_multi(jnp.asarray(d), JPo.build_step_matrix(jnp.asarray(t)), p.digit_limbs, 2)
    _eq(port, ref)
    with pytest.raises(ValueError, match="2\\^53"):
        PPo.polymul_small_by_torus(torch.from_numpy(d), to_torch(t, "cpu"), 1 << 30)


@pytest.mark.parametrize(
    "name", ["TEST_TINY", "SECURITY_128_BIT", "SECURITY_128_BIT_FAST", "SECURITY_UINT1", "SECURITY_UINT2"]
)
def test_gadget_decompose_matches(name):
    p = getattr(JP, name)
    x = _u32(np.random.default_rng(4), (3, 2, 64))
    port = PD.gadget_decompose(to_torch(x, "cpu"), params_from(p))
    np.testing.assert_array_equal(port.numpy(), np.asarray(JD.gadget_decompose(jnp.asarray(x), p)))


@pytest.mark.parametrize("name", ["TEST_TINY", "SECURITY_128_BIT_FAST", "SECURITY_128_BIT_NIBBLE"])
def test_modswitch_matches(name):
    p = getattr(JP, name)
    x = _u32(np.random.default_rng(5), (4, 33))
    port = PBR.modswitch(to_torch(x, "cpu"), params_from(p))
    ref = JBR.modswitch(jnp.asarray(x), p)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert int(port.min()) >= 0 and int(port.max()) < 2 * p.n1


@pytest.mark.parametrize("k", [0, 5, 63])
def test_sample_extract_matches(k):
    acc = _u32(np.random.default_rng(6), (4, 2, 64))
    _eq(PE.sample_extract(to_torch(acc, "cpu"), k), JE.sample_extract(jnp.asarray(acc), k))


def _shared_trlwe_setup(rng):
    s1 = rng.integers(0, 2, TINY.n1).astype(np.uint32)
    mu = _u32(rng, (3, TINY.n1))
    return s1, mu


def test_trlwe_phase_matches():
    rng = np.random.default_rng(7)
    s1, mu = _shared_trlwe_setup(rng)
    ct = JR.trlwe_encrypt_torus(jax.random.key(1), jnp.asarray(s1), jnp.asarray(mu), 1e-12)
    _eq(PR.trlwe_phase(to_torch(np.asarray(ct), "cpu"), to_torch(s1, "cpu")), JR.trlwe_phase(ct, jnp.asarray(s1)))


@pytest.mark.parametrize("grid", [0, 8])
def test_trlwe_encrypt_decrypts(grid):
    """Port encryption (torch generator): the phase is mu plus small noise,
    and with grid bits the mask and body sit on the 2^grid grid."""
    rng = np.random.default_rng(8)
    s1, mu = _shared_trlwe_setup(rng)
    g = torch.Generator().manual_seed(8)
    ct = PR.trlwe_encrypt_torus(g, to_torch(s1, "cpu"), to_torch(mu, "cpu"), 1e-9, mask_grid_bits=grid)
    err = (PR.trlwe_phase(ct, to_torch(s1, "cpu")) - to_torch(mu, "cpu")).abs()
    assert int(err.max()) < 64 + (1 << grid)
    if grid:
        assert int((ct & ((1 << grid) - 1)).abs().max()) == 0


def test_external_product_and_cmux_match():
    """TRGSW (x) TRLWE and CMUX on a JAX-made TRGSW, bit-exact; the port's
    own TRGSW encryption selects correctly."""
    rng = np.random.default_rng(9)
    p, pp = TINY, params_from(TINY)
    s1 = rng.integers(0, 2, p.n1).astype(np.uint32)
    c = JG.trgsw_encrypt_torus(jax.random.key(2), jnp.asarray(s1), jnp.asarray(1, jnp.uint32), p.bsk_alpha, p)
    c0, c1 = _u32(rng, (4, 2, p.n1)), _u32(rng, (4, 2, p.n1))
    _eq(
        PG.external_product(to_torch(np.asarray(c), "cpu"), to_torch(c1, "cpu"), pp),
        JG.external_product(c, jnp.asarray(c1), p),
    )
    _eq(
        PG.cmux(to_torch(c0, "cpu"), to_torch(c1, "cpu"), to_torch(np.asarray(c), "cpu"), pp),
        JG.cmux(jnp.asarray(c0), jnp.asarray(c1), c, p),
    )
    g = torch.Generator().manual_seed(9)
    mu = [to_torch(_u32(rng, (p.n1,)) & np.uint32(0xF0000000), "cpu") for _ in range(2)]
    e0, e1 = (PR.trlwe_encrypt_torus(g, to_torch(s1, "cpu"), m, p.bsk_alpha) for m in mu)
    for bit in (0, 1):
        sel = PG.trgsw_encrypt_torus(g, to_torch(s1, "cpu"), torch.tensor(bit, dtype=torch.int32), p.bsk_alpha, pp)
        phase = PR.trlwe_phase(PG.cmux(e0, e1, sel, pp), to_torch(s1, "cpu"))
        assert int((phase - mu[bit]).abs().max()) < 1 << 20

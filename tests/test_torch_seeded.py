"""PyTorch port: seeded transport and keys with a `gen_seed` against the JAX
package at TEST_TINY, with tolerance 0 where the arithmetic is exact:
`lwe_expand_seeded`, `expand_radix_seeded` and `lwe_rows_limbs_from_bodies`
(limb layouts converted), seeded encryption decrypted across the packages
both ways (also through `FheBool` and `FheUintRadix`), and the masks of the
port's keygen from a `gen_seed` against JAX's `CloudKey.generate` from the
same key. The noise is drawn apart, so bodies are held by decryption and by
`utils.noise`."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import fhe as JF  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.key import round_bsk as j_round_bsk  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu_torch import fhe as PF  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import native as PNAT  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic as PA  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402
from rs_tfhe_tpu_torch.utils import noise as PNo  # noqa: E402


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
GEN_SEED = 412


@pytest.fixture(scope="module")
def keys():
    """A JAX secret key and multi-bit cloud key from jax.random.key(GEN_SEED),
    the port's secret key from the same arrays, and the port's multi-bit key
    generated from the same gen_seed."""
    jsk = JSecretKey.generate(jax.random.key(411), TINY)
    jck = JCloudKey.generate(jax.random.key(GEN_SEED), jsk, multibit=True)
    psk = PK.secret_key_from_numpy({"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1)}, PTINY, "cpu")
    pck = PK.CloudKey.generate(psk, torch.Generator().manual_seed(413), multibit=True,
                               gen_seed=PTo.key_data(GEN_SEED))
    return jsk, jck, psk, pck


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def _jax_rows(limbs) -> np.ndarray:
    """A JAX planar-padded limb table -> its rows, uint32 [R, n0+1]."""
    return to_numpy(PTo.rows_from_planar_limbs(torch.from_numpy(np.array(limbs)), TINY.n0 + 1))


def _port_rows(limbs: torch.Tensor) -> np.ndarray:
    return to_numpy(PTo.rows_from_planar_limbs(limbs, PTINY.n0 + 1))


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_lwe_expand_seeded_matches_jax(batch):
    rng = np.random.default_rng(batch)
    seed, bodies = _words(rng, 2), _words(rng, batch)
    ref = np.asarray(JT.lwe_expand_seeded(jnp.asarray(seed), jnp.asarray(bodies), TINY.n0))
    port = PT.lwe_expand_seeded(seed, to_torch(bodies, "cpu"), PTINY.n0)
    np.testing.assert_array_equal(to_numpy(port), ref)
    np.testing.assert_array_equal(PNAT.lwe_expand_seeded(seed, bodies, TINY.n0), ref)


def test_expand_radix_seeded_matches_jax():
    rng = np.random.default_rng(7)
    seed, bodies = _words(rng, 2), _words(rng, 3, 4)
    ref = np.asarray(JA.expand_radix_seeded(jnp.asarray(seed), jnp.asarray(bodies), TINY.n0))
    port = PA.expand_radix_seeded(seed, to_torch(bodies, "cpu"), PTINY.n0)
    assert port.shape == (3, 4, TINY.n0 + 1)
    np.testing.assert_array_equal(to_numpy(port), ref)


@pytest.mark.parametrize("zeroed", [False, True])
def test_rows_limbs_from_bodies_matches_jax(zeroed):
    rng = np.random.default_rng(8)
    rows = 96
    seed, bodies = _words(rng, 2), _words(rng, rows)
    zero = np.arange(rows) % 4 == 0 if zeroed else None
    ref = JT.lwe_rows_limbs_from_bodies(
        jax.random.wrap_key_data(jnp.asarray(seed)), jnp.asarray(bodies), TINY.n0,
        zero_mask=None if zero is None else jnp.asarray(zero),
    )
    port = PT.lwe_rows_limbs_from_bodies(seed, to_torch(bodies, "cpu"), PTINY.n0,
                                         zero_mask=None if zero is None else torch.from_numpy(zero))
    assert port.shape == (rows, 4 * PK.ksk_width(PTINY)) and port.dtype == torch.int8
    np.testing.assert_array_equal(_port_rows(port), _jax_rows(ref))
    assert torch.equal(port, PTo.planar_limbs(to_torch(_jax_rows(ref), "cpu")))


def test_encrypt_rows_limbs_masks_match_jax(keys):
    """JAX's mask key is the first split of the key it is called with; the
    port takes that mask key, and its noise from the generator."""
    jsk, _, psk, _ = keys
    mu = np.random.default_rng(9).integers(0, 2**32, 40, dtype=np.uint32)
    jkey = jax.random.key(77)
    ref = _jax_rows(JT.lwe_encrypt_rows_limbs(jkey, jsk.lv0, jnp.asarray(mu), TINY.tlwe_lv0.alpha))
    mask_key = PTo.split(PTo.key_data(77))[0]
    port = _port_rows(PT.lwe_encrypt_rows_limbs(torch.Generator().manual_seed(1), mask_key, psk.lv0,
                                                to_torch(mu, "cpu"), PTINY.tlwe_lv0.alpha))
    np.testing.assert_array_equal(port[:, :-1], ref[:, :-1])
    bound = 7 * PNo.estimate(PTINY).fresh_lv0_std
    noise = PNo.measure_phase_noise(to_torch(port, "cpu"), psk.lv0, mu)
    assert np.abs(noise).max() <= bound


def test_seeded_encryption_crosses_both_ways(keys):
    jsk, _, psk, _ = keys
    msgs = np.random.default_rng(10).integers(0, 2, 48).astype(bool)
    mask_key = PTo.key_data(2024)
    seed, bodies = PT.lwe_encrypt_bool_seeded(torch.Generator().manual_seed(2), mask_key, psk.lv0, msgs,
                                              PTINY.tlwe_lv0.alpha)
    assert torch.equal(seed, PTo.key_tensor(mask_key)) and bodies.shape == (48,)
    jct = JT.lwe_expand_seeded(jnp.asarray(to_numpy(seed)), jnp.asarray(to_numpy(bodies)), TINY.n0)
    np.testing.assert_array_equal(np.asarray(JT.lwe_decrypt_bool(jct, jsk.lv0)), msgs)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(PT.lwe_expand_seeded(seed, bodies, PTINY.n0), psk.lv0), msgs)

    jseed, jbodies = JT.lwe_encrypt_bool_seeded(jax.random.key(3), jsk.lv0, jnp.asarray(msgs), TINY.tlwe_lv0.alpha)
    pct = PT.lwe_expand_seeded(np.asarray(jseed), to_torch(np.asarray(jbodies), "cpu"), PTINY.n0)
    np.testing.assert_array_equal(to_numpy(pct), np.asarray(JT.lwe_expand_seeded(jseed, jbodies, TINY.n0)))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(pct, psk.lv0), msgs)


def test_seeded_radix_and_typed_api_cross_both_ways(keys):
    jsk, jck, psk, pck = keys
    vals = np.asarray([0, 5, 300, 511])
    g = torch.Generator().manual_seed(4)
    seed, bodies = PF.FheUintRadix.encrypt_seeded(g, PTo.key_data(5), psk.lv0, vals, 3, PTINY)
    assert bodies.shape == (4, 3)
    jct = JA.expand_radix_seeded(jnp.asarray(to_numpy(seed)), jnp.asarray(to_numpy(bodies)), TINY.n0)
    np.testing.assert_array_equal(JA.decrypt_radix(jct, jsk.lv0), vals)
    np.testing.assert_array_equal(PF.FheUintRadix.expand_seeded(seed, bodies, pck).decrypt(psk.lv0), vals)

    jseed, jbodies = JF.FheUintRadix.encrypt_seeded(jax.random.key(6), jsk.lv0, vals, 3, TINY)
    port = PF.FheUintRadix.expand_seeded(np.asarray(jseed), to_torch(np.asarray(jbodies), "cpu"), pck)
    np.testing.assert_array_equal(to_numpy(port.digits), np.asarray(JA.expand_radix_seeded(jseed, jbodies, TINY.n0)))
    np.testing.assert_array_equal(port.decrypt(psk.lv0), vals)

    bits = np.asarray([True, False, False, True, True])
    seed, bodies = PF.FheBool.encrypt_seeded(g, PTo.key_data(7), psk.lv0, bits, PTINY)
    jct = JT.lwe_expand_seeded(jnp.asarray(to_numpy(seed)), jnp.asarray(to_numpy(bodies)), TINY.n0)
    np.testing.assert_array_equal(np.asarray(JT.lwe_decrypt_bool(jct, jsk.lv0)), bits)
    jseed, jbodies = JF.FheBool.encrypt_seeded(jax.random.key(8), jsk.lv0, bits, TINY)
    np.testing.assert_array_equal(
        PF.FheBool.expand_seeded(np.asarray(jseed), to_torch(np.asarray(jbodies), "cpu"), pck).decrypt(psk.lv0), bits
    )


def test_keygen_masks_match_jax_from_one_gen_seed(keys):
    """Same gen_seed: the same KSK, BSK and multi-bit masks as the JAX key;
    bodies that differ only by noise, each within utils.noise's bound."""
    jsk, jck, psk, pck = keys
    np.testing.assert_array_equal(to_numpy(pck.gen_seed), np.asarray(jck.gen_seed))
    jrows, prows = _jax_rows(jck.ksk_limbs), _port_rows(pck.ksk_limbs)
    np.testing.assert_array_equal(prows[:, :-1], jrows[:, :-1])
    zero = to_numpy(PK.ksk_zero_rows(PTINY, "cpu").to(torch.int32)).astype(bool)
    assert not prows[zero].any() and not jrows[zero].any()
    bound = 7 * PNo.estimate(PTINY).fresh_lv0_std
    mu = prows[:, -1] - (prows[:, :-1].astype(np.uint64) * np.asarray(jsk.lv0)).sum(-1).astype(np.uint32)
    for rows in (prows, jrows):
        noise = PNo.measure_phase_noise(to_torch(rows[~zero], "cpu"), psk.lv0, mu[~zero])
        assert np.abs(noise).max() <= 2 * bound
    jb, pb = np.asarray(jck.bsk), to_numpy(pck.bsk)
    np.testing.assert_array_equal(pb[:, :, 0], jb[:, :, 0])
    jm, pm = np.asarray(jck.bsk_mb), to_numpy(pck.bsk_mb)
    np.testing.assert_array_equal(pm[..., 0, :], jm[..., 0, :])
    # TEST_TINY's BSK noise (alpha 1e-12, 0.004 of a torus word) truncates to 0
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(to_numpy(pck.testvec), np.asarray(jck.testvec))


def test_gen_seed_seeds_masks_and_never_noise(keys):
    """Two keys from one gen_seed and differently seeded generators share
    every mask word and differ in their bodies: no noise word can be
    replayed from gen_seed."""
    _, _, psk, pck = keys
    other = PK.CloudKey.generate(psk, torch.Generator().manual_seed(999), multibit=True,
                                 gen_seed=to_numpy(pck.gen_seed))
    a, b = _port_rows(pck.ksk_limbs), _port_rows(other.ksk_limbs)
    np.testing.assert_array_equal(a[:, :-1], b[:, :-1])
    assert (a[:, -1] != b[:, -1]).sum() > a.shape[0] // 2
    assert torch.equal(pck.bsk[:, :, 0], other.bsk[:, :, 0]) and torch.equal(pck.bsk_mb[..., 0, :], other.bsk_mb[..., 0, :])


def test_generate_draws_gen_seed_from_the_generator(keys):
    _, _, psk, _ = keys
    k1 = PK.CloudKey.generate(psk, torch.Generator().manual_seed(5))
    k2 = PK.CloudKey.generate(psk, torch.Generator().manual_seed(5))
    k3 = PK.CloudKey.generate(psk, torch.Generator().manual_seed(6))
    assert k1.gen_seed.shape == (2,) and k1.gen_seed.dtype == torch.int32
    assert torch.equal(k1.gen_seed, k2.gen_seed) and torch.equal(k1.ksk_limbs, k2.ksk_limbs)
    assert not torch.equal(k1.gen_seed, k3.gen_seed)
    assert PK.CloudKey.generate_no_ksk(PTINY, "cpu").gen_seed is None


def test_round_bsk_matches_jax():
    bsk = np.random.default_rng(11).integers(0, 2**32, (3, 6, 2, 64), dtype=np.uint32)
    for bits in (0, 1, 8, 12):
        np.testing.assert_array_equal(to_numpy(PK.round_bsk(to_torch(bsk, "cpu"), bits)),
                                      np.asarray(j_round_bsk(jnp.asarray(bsk), bits)))

"""PyTorch port: `proxy_reenc` and `ops/poly.exact_dot_i8` against the JAX
package at TEST_TINY. `reencrypt` is bit-exact against JAX's on the same
re-encryption key (JAX's table carried into the port's layout) and the same
ciphertexts, for symmetric and asymmetric keys; the port's own symmetric and
asymmetric re-keying decrypt under the target key; `exact_dot_i8` is
bit-exact, including shapes the card's int8 product pads."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import proxy_reenc as JPR  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.ops.poly import exact_dot_i8 as j_exact_dot_i8  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import proxy_reenc as PPR  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import exact_dot_i8  # noqa: E402
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


@pytest.fixture(scope="module")
def parties():
    """Alice and Bob as JAX secret keys and as the port's, Bob's JAX public
    key, and a batch of Alice's ciphertexts with its bits."""
    ja, jb = (JSecretKey.generate(jax.random.key(s), TINY) for s in (601, 602))
    pa, pb = (PK.secret_key_from_numpy({"lv0": np.asarray(k.lv0), "lv1": np.asarray(k.lv1)}, PTINY, "cpu")
              for k in (ja, jb))
    bits = np.random.default_rng(603).integers(0, 2, 64).astype(bool)
    ct = np.asarray(JT.lwe_encrypt_bool(jax.random.key(604), ja.lv0, jnp.asarray(bits), TINY.tlwe_lv0.alpha))
    jpk = JPR.PublicKeyLv0.generate(jax.random.key(605), jb.lv0, TINY)
    return ja, jb, pa, pb, jpk, ct, bits


def _port_rk(jrk) -> PPR.ProxyReencryptionKey:
    rows = PTo.rows_from_planar_limbs(torch.from_numpy(np.array(jrk.table_limbs)), TINY.n0 + 1)
    return PPR.ProxyReencryptionKey(PTo.planar_limbs(rows), jrk.basebit, jrk.t, PTINY)


@pytest.mark.parametrize("shape", [(1, 8, 24), (5, 13, 7), (40, 1400, 256), (3, 4, 96, 17)])
def test_exact_dot_i8_matches_jax(shape):
    *lead, k, m = shape
    rng = np.random.default_rng(k)
    lhs = rng.integers(-128, 128, (*lead, k), dtype=np.int8)
    rhs = rng.integers(-128, 128, (k, m), dtype=np.int8)
    lhs[..., 0] = -128
    rhs[0] = -128  # the extreme product
    port = exact_dot_i8(torch.from_numpy(lhs), torch.from_numpy(rhs))
    assert port.dtype == torch.int32 and port.shape == (*lead, m)
    np.testing.assert_array_equal(port.numpy(), np.asarray(j_exact_dot_i8(jnp.asarray(lhs), jnp.asarray(rhs))))
    np.testing.assert_array_equal(port.numpy(), np.einsum("...k,km->...m", lhs.astype(np.int64), rhs.astype(np.int64)))


def test_exact_dot_i8_takes_a_key_switch_contraction_past_2_17():
    """NIBBLE's key switch contracts N*t*base = 196,608 one-hot terms."""
    k = 4096 * 12 * 4
    rng = np.random.default_rng(5)
    lhs = np.zeros((3, k), dtype=np.int8)
    lhs[np.arange(3)[:, None], rng.integers(0, k, (3, 4096 * 12))] = 1
    rhs = rng.integers(-128, 128, (k, 8), dtype=np.int8)
    port = exact_dot_i8(torch.from_numpy(lhs), torch.from_numpy(rhs)).numpy()
    np.testing.assert_array_equal(port, lhs.astype(np.int64) @ rhs.astype(np.int64))


def test_exact_dot_i8_rejects_bad_operands():
    with pytest.raises(ValueError, match="int8"):
        exact_dot_i8(torch.zeros(4, 8, dtype=torch.int32), torch.zeros(8, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        exact_dot_i8(torch.zeros(4, 8, dtype=torch.int8), torch.zeros(9, 8, dtype=torch.int8))


@pytest.mark.parametrize("mode", ["symmetric", "asymmetric", "custom"])
def test_reencrypt_matches_jax_bit_for_bit(parties, mode):
    ja, jb, pa, pb, jpk, ct, bits = parties
    if mode == "asymmetric":
        jrk = JPR.new_asymmetric(jax.random.key(606), ja.lv0, jpk, TINY)
    else:
        extra = {"basebit": 3, "t": 6} if mode == "custom" else {}
        jrk = JPR.new_symmetric(jax.random.key(607), ja.lv0, jb.lv0, TINY, **extra)
    ref = np.asarray(JPR.reencrypt(jnp.asarray(ct), jrk))
    port = PPR.reencrypt(to_torch(ct, "cpu"), _port_rk(jrk))
    np.testing.assert_array_equal(to_numpy(port), ref)
    np.testing.assert_array_equal(to_numpy(PPR.reencrypt_tlwe_lv0(to_torch(ct, "cpu"), _port_rk(jrk))), ref)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(port, pb.lv0).numpy(), bits)


def test_public_key_from_jax_encryptions_matches_its_limbs(parties):
    *_, jpk, _, _ = parties
    pk = PPR.PublicKeyLv0(to_torch(np.asarray(jpk.encryptions), "cpu"), PTINY)
    rows = PTo.rows_from_planar_limbs(torch.from_numpy(np.array(jpk.limbs)), TINY.n0 + 1)
    assert torch.equal(pk.limbs, PTo.planar_limbs(rows))


def test_port_rekeying_decrypts(parties):
    """The port's own keys: Bob's public key encrypts, and both re-keyings
    (and a two-hop chain) carry Alice's bits to Bob's key."""
    _, _, pa, pb, _, ct, bits = parties
    g = torch.Generator().manual_seed(608)
    pk = PPR.PublicKeyLv0.generate(g, pb.lv0, PTINY)
    assert pk.encryptions.shape == (2 * PTINY.n0, PTINY.n0 + 1)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(pk.encrypt_bool(g, bits, PTINY.tlwe_lv0.alpha), pb.lv0).numpy(),
                                  bits)
    ct = to_torch(ct, "cpu")
    for rk in (PPR.new_symmetric(g, pa.lv0, pb.lv0, PTINY), PPR.new_asymmetric(g, pa.lv0, pk, PTINY),
               PPR.new_symmetric(g, pa.lv0, pb.lv0, PTINY, alpha=PTINY.ksk_alpha * 0.8, basebit=3, t=6)):
        g_ = PTINY.trgsw_lv1
        assert rk.table_limbs.shape[0] == PTINY.n0 * rk.t * rk.base and rk.base == 1 << rk.basebit
        assert (rk.basebit, rk.t) in ((g_.basebit, g_.iks_t), (3, 6))
        np.testing.assert_array_equal(PT.lwe_decrypt_bool(PPR.reencrypt(ct, rk), pb.lv0).numpy(), bits)
    carol = PK.SecretKey.generate(PTINY, g)
    hop = PPR.reencrypt(PPR.reencrypt(ct, PPR.new_symmetric(g, pa.lv0, pb.lv0, PTINY)),
                        PPR.new_asymmetric(g, pb.lv0, PPR.PublicKeyLv0.generate(g, carol.lv0, PTINY), PTINY))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(hop, carol.lv0).numpy(), bits)


def test_generate_keys_for_test():
    alice, bob, bob_pk = PPR.generate_keys_for_test(torch.Generator().manual_seed(609), PTINY)
    assert not torch.equal(alice.lv0, bob.lv0) and bob_pk.params == PTINY
    msgs = np.asarray([True, False, True])
    ct = bob_pk.encrypt_bool(torch.Generator().manual_seed(610), msgs, PTINY.tlwe_lv0.alpha)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(ct, bob.lv0).numpy(), msgs)

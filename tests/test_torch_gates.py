"""PyTorch port: key switching, gate linear forms and the whole bootstrapped
gate at TEST_TINY, held bit-exact (tolerance 0) against the JAX package on
the same keys and ciphertexts (JAX keygen, carried over with
`cloud_key_from_numpy`), plus the port's own keygen and encryption checked
by truth table, decrypted by both packages."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import bootstrap as JB  # noqa: E402
from rs_tfhe_tpu import gates as JGa  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.ops import keyswitch as JKS  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu.torus import recombine_planar as j_recombine_planar  # noqa: E402
from rs_tfhe_tpu_torch import bootstrap as PB  # noqa: E402
from rs_tfhe_tpu_torch import gates as PGa  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.ops import keyswitch as PKS  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import recombine_planar, to_numpy, to_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


P = TEST_TINY
PP = params_from(TEST_TINY)
_GATES = {
    "nand": lambda a, b: ~(a & b),
    "or": lambda a, b: a | b,
    "and": lambda a, b: a & b,
    "xor": lambda a, b: a ^ b,
    "xnor": lambda a, b: ~(a ^ b),
    "nor": lambda a, b: ~(a | b),
    "and_ny": lambda a, b: ~a & b,
    "and_yn": lambda a, b: a & ~b,
    "or_ny": lambda a, b: ~a | b,
    "or_yn": lambda a, b: a | ~b,
}


@pytest.fixture(scope="module")
def shared():
    """JAX keys and ciphertexts, and the same material in the port."""
    sk = JSecretKey.generate(jax.random.key(31), P)
    ck = JCloudKey.generate(jax.random.key(32), sk)
    bits = np.random.default_rng(33).integers(0, 2, (3, 16)).astype(bool)
    keys = jax.random.split(jax.random.key(34), 3)
    cts = [JT.lwe_encrypt_bool(k, sk.lv0, jnp.asarray(m), P.tlwe_lv0.alpha) for k, m in zip(keys, bits)]
    arrays = {
        "lv0": np.asarray(sk.lv0), "lv1": np.asarray(sk.lv1), "testvec": np.asarray(ck.testvec),
        "bsk": np.asarray(ck.bsk), "ksk_limbs": np.asarray(ck.ksk_limbs),
    }
    return dict(
        jsk=sk, jck=ck, bits=bits, jct=cts,
        psk=PK.secret_key_from_numpy(arrays, PP, "cpu"), pck=PK.cloud_key_from_numpy(arrays, PP, "cpu"),
        pct=[to_torch(np.asarray(c), "cpu") for c in cts],
    )


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(35)
    sk = PK.SecretKey.generate(PP, g)
    return g, sk, PK.CloudKey.generate(sk, g)


def test_cloud_key_from_numpy_recombines_ksk(shared):
    ck, pck = shared["jck"], shared["pck"]
    w = PK.ksk_width(PP)
    rows = j_recombine_planar(ck.ksk_limbs.reshape(ck.ksk_limbs.shape[0], 4, -1).astype(jnp.int32))
    rows = rows[:, : P.n0 + 1]
    port_rows = recombine_planar(pck.ksk_limbs.reshape(-1, 4, w).to(torch.int32))
    np.testing.assert_array_equal(to_numpy(port_rows[:, : P.n0 + 1]), np.asarray(rows))
    assert int(port_rows[:, P.n0 + 1 :].abs().max()) == 0
    np.testing.assert_array_equal(to_numpy(pck.bsk), np.asarray(ck.bsk))
    np.testing.assert_array_equal(to_numpy(pck.testvec), np.asarray(ck.testvec))
    assert pck.ksk_limbs.dtype == torch.int8 and w % 8 == 0


def test_identity_key_switch_matches(shared):
    lv1 = np.random.default_rng(36).integers(0, 1 << 32, (5, P.n1 + 1), dtype=np.uint32)
    port = PKS.identity_key_switch(to_torch(lv1, "cpu"), shared["pck"].ksk_limbs, PP)
    ref = JKS.identity_key_switch(jnp.asarray(lv1), shared["jck"].ksk_limbs, P)
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


@pytest.mark.parametrize("name", sorted(_GATES))
def test_linear_form_matches_at_wrap_edges(name):
    """Each gate's wrapping linear form on words at the uint32 wrap edges."""
    edges = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xE0000000], dtype=np.uint32)
    a = np.repeat(edges, len(edges))[:, None] + np.zeros((1, P.n0 + 1), np.uint32)
    b = np.tile(edges, len(edges))[:, None] + np.arange(P.n0 + 1, dtype=np.uint32)[None, :]
    port = PGa._LINEAR_FORMS[name](to_torch(a, "cpu"), to_torch(b, "cpu"))
    ref = JGa._LINEAR_FORMS[name](jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


def test_nand_batch_gate_bootstrap_match(shared):
    (ja, jb, _), (pa, pb, _) = shared["jct"], shared["pct"]
    jck, pck = shared["jck"], shared["pck"]
    ref = np.asarray(JGa.nand(ja, jb, jck))
    np.testing.assert_array_equal(to_numpy(PGa.nand(pa, pb, pck)), ref)
    np.testing.assert_array_equal(to_numpy(PGa.batch_gate("nand", pa, pb, pck)), ref)
    np.testing.assert_array_equal(to_numpy(PB.bootstrap(pa, pck)), np.asarray(JB.bootstrap(ja, jck)))
    np.testing.assert_array_equal(
        to_numpy(PB.bootstrap_without_key_switch(pa, pck)),
        np.asarray(JB.bootstrap_without_key_switch(ja, jck)),
    )
    dec = PT.lwe_decrypt_bool(PGa.nand(pa, pb, pck), shared["psk"].lv0).numpy()
    np.testing.assert_array_equal(dec, ~(shared["bits"][0] & shared["bits"][1]))


def test_mux_matches(shared):
    ja, jb, jc = shared["jct"]
    pa, pb, pc = shared["pct"]
    ref = np.asarray(JGa.mux(ja, jb, jc, shared["jck"]))
    out = PGa.mux(pa, pb, pc, shared["pck"])
    np.testing.assert_array_equal(to_numpy(out), ref)
    bits = shared["bits"]
    np.testing.assert_array_equal(
        PT.lwe_decrypt_bool(out, shared["psk"].lv0).numpy(), np.where(bits[0], bits[1], bits[2])
    )


def test_not_copy_constant_match():
    x = np.random.default_rng(37).integers(0, 1 << 32, (4, P.n0 + 1), dtype=np.uint32)
    np.testing.assert_array_equal(to_numpy(PGa.not_(to_torch(x, "cpu"))), np.asarray(JGa.not_(jnp.asarray(x))))
    np.testing.assert_array_equal(to_numpy(PGa.copy(to_torch(x, "cpu"))), x)
    for value in (True, False, [True, False, False, True]):
        np.testing.assert_array_equal(
            to_numpy(PGa.constant(value, 4, PP, "cpu")), np.asarray(JGa.constant(value, 4, P))
        )


@pytest.mark.parametrize("name", sorted(_GATES))
def test_port_keygen_truth_table(port_keys, name):
    """The port's own keygen and encryption (torch generator): every input
    pair, decrypted by the port and by the JAX package."""
    g, sk, ck = port_keys
    ma = np.array([False, False, True, True] * 2)
    mb = np.array([False, True, False, True] * 2)
    a = PT.lwe_encrypt_bool(g, sk.lv0, ma, PP.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, sk.lv0, mb, PP.tlwe_lv0.alpha)
    out = getattr(PGa, {"or": "or_", "and": "and_"}.get(name, name))(a, b, ck)
    expect = _GATES[name](ma, mb)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, sk.lv0).numpy(), expect)
    jdec = JT.lwe_decrypt_bool(jnp.asarray(to_numpy(out)), jnp.asarray(to_numpy(sk.lv0)))
    np.testing.assert_array_equal(np.asarray(jdec), expect)


def test_port_keygen_mux_and_chain(port_keys):
    """MUX and a chain of dependent gates on the port's own keys."""
    g, sk, ck = port_keys
    m = np.random.default_rng(38).integers(0, 2, (3, 8)).astype(bool)
    a, b, c = (PT.lwe_encrypt_bool(g, sk.lv0, x, PP.tlwe_lv0.alpha) for x in m)
    out = PGa.mux(a, b, c, ck)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, sk.lv0).numpy(), np.where(m[0], m[1], m[2]))
    cur, expect = a, m[0]
    for _ in range(4):
        cur, expect = PGa.nand(cur, b, ck), ~(expect & m[1])
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(cur, sk.lv0).numpy(), expect)

"""PyTorch port: the main path's API leftovers against the JAX package with
tolerance 0 at TEST_TINY, on JAX keys carried into the port, with a standard
and a multi-bit key: the `Gates` class with and without an injected
strategy, `mux_naive`, `trgsw.batch_blind_rotate`,
`ops/extract.sample_extract_to_lv0_width`; and the port's own
`CloudKey.generate_no_ksk` and `generate_secure` (every secret word from
the operating system's CSPRNG). Mirrors tests/test_gates.py and
tests/test_api_coverage.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import bootstrap as JB  # noqa: E402
from rs_tfhe_tpu import gates as JG  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu import trgsw as JTG  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.ops import extract as JE  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
import rs_tfhe_tpu_torch as pt  # noqa: E402
from rs_tfhe_tpu_torch import bootstrap as PB  # noqa: E402
from rs_tfhe_tpu_torch import gates as PG  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch import trgsw as PTG  # noqa: E402
from rs_tfhe_tpu_torch.ops import extract as PE  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
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


P = TEST_TINY
PP = params_from(TEST_TINY)
A = np.array([True, True, False, False])
B = np.array([True, False, True, False])
C = np.array([False, True, True, False])
TRUTH = {
    "nand": ~(A & B), "or_": A | B, "and_": A & B, "xor": A ^ B, "xnor": ~(A ^ B), "nor": ~(A | B),
    "and_ny": ~A & B, "and_yn": A & ~B, "or_ny": ~A | B, "or_yn": A | ~B,
}
STRATEGIES = {"default": (lambda: None, lambda: None), "vanilla": (JB.VanillaBootstrap, PB.VanillaBootstrap),
              "lut": (JB.LutBootstrap, PB.LutBootstrap)}


@pytest.fixture(scope="module", params=["standard", "multibit"])
def shared(request):
    """JAX keys, three JAX-encrypted bit batches, and the same in the port.
    With the multi-bit key every batch of 4 takes the multi-bit rotation."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(240), P)
    jck = JCloudKey.generate(jax.random.key(241), jsk, multibit=mb)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    keys = jax.random.split(jax.random.key(242), 3)
    jcts = [JT.lwe_encrypt_bool(k, jsk.lv0, jnp.asarray(m), P.tlwe_lv0.alpha) for k, m in zip(keys, (A, B, C))]
    return dict(jsk=jsk, jck=jck, jcts=jcts, psk=PK.secret_key_from_numpy(arrays, PP, "cpu"),
                pck=PK.cloud_key_from_numpy(arrays, PP, "cpu"), pcts=[to_torch(np.asarray(c), "cpu") for c in jcts])


def _dec(ct, psk):
    return PT.lwe_decrypt_bool(ct, psk.lv0).numpy()


@pytest.mark.parametrize(
    "shared, strategy",
    [("standard", "default"), ("standard", "vanilla"), ("standard", "lut"), ("multibit", "default")],
    indirect=["shared"],
)
def test_gates_class_matches_jax(shared, strategy):
    """All 10 gates, mux and mux_naive through Gates(strategy), bit for bit
    against JAX's Gates(strategy), each decrypting to its truth table; with
    the multi-bit key (every batch of 4 on the multi-bit rotation) the
    default strategy. The module's mux_naive equals the default Gates'."""
    jmake, pmake = STRATEGIES[strategy]
    jg, pg = JG.Gates(jmake()), PG.Gates(pmake())
    assert pg.bootstrap_strategy == jg.bootstrap_strategy == ("vanilla" if strategy == "default" else strategy)

    def run(a, b, c, ck):
        return tuple(getattr(jg, name)(a, b, ck) for name in TRUTH) + (jg.mux(a, b, c, ck), jg.mux_naive(a, b, c, ck))

    refs = jax.jit(run)(*shared["jcts"], shared["jck"])
    a, b, c = shared["pcts"]
    pck, psk = shared["pck"], shared["psk"]
    outs = [getattr(pg, name)(a, b, pck) for name in TRUTH] + [pg.mux(a, b, c, pck), pg.mux_naive(a, b, c, pck)]
    wants = list(TRUTH.values()) + [np.where(A, B, C)] * 2
    for name, out, ref, want in zip([*TRUTH, "mux", "mux_naive"], outs, refs, wants):
        np.testing.assert_array_equal(to_numpy(out), np.asarray(ref), err_msg=name)
        np.testing.assert_array_equal(_dec(out, psk), want, err_msg=name)
    if strategy == "default":
        np.testing.assert_array_equal(to_numpy(PG.mux_naive(a, b, c, pck)), np.asarray(refs[-1]))
        assert pt.Gates is PG.Gates
    assert torch.equal(pg.not_(a), PG.not_(a)) and pg.copy(a) is a
    const = pg.constant(True, 2, PP, "cpu")
    assert torch.equal(const, PG.constant(True, 2, PP, "cpu")) and _dec(const, psk).tolist() == [True, True]


def test_batch_blind_rotate_matches_jax(shared):
    """The parity alias runs the standard rotation (the key's `bsk`); its
    accumulator, extracted and key-switched, decrypts to the sign test."""
    jck, pck = shared["jck"], shared["pck"]
    ref = np.asarray(JTG.batch_blind_rotate(shared["jcts"][0], jck.testvec, jck.bsk, P))
    acc = PTG.batch_blind_rotate(shared["pcts"][0], pck.testvec, pck.bsk, PP)
    np.testing.assert_array_equal(to_numpy(acc), ref)
    lv0 = identity_key_switch(PE.sample_extract(acc, 0), pck.ksk_limbs, PP)
    np.testing.assert_array_equal(_dec(lv0, shared["psk"]), A)


@pytest.mark.parametrize("k", [0, 7, 15])
def test_sample_extract_to_lv0_width_matches_jax(k):
    """k = 0, a middle index and n0 - 1, words at and above 2^31 included."""
    trlwe = np.random.default_rng(243).integers(0, 1 << 32, (3, 2, PP.n1), dtype=np.uint32)
    trlwe[0, 0, :4] = [0x80000000, 0xFFFFFFFF, 0, 1]
    ref = np.asarray(JE.sample_extract_to_lv0_width(jnp.asarray(trlwe), PP.n0, k))
    out = PE.sample_extract_to_lv0_width(to_torch(trlwe, "cpu"), PP.n0, k)
    assert tuple(out.shape) == (3, PP.n0 + 1)
    np.testing.assert_array_equal(to_numpy(out), ref)


def test_generate_no_ksk_shapes_and_zeros():
    """All-zero keys in the port's own layouts (ksk_limbs with `ksk_width`
    columns a limb plane, not the JAX package's lane padding), the real test
    vector, and the bsk and testvec of JAX's no-KSK key."""
    for p in (PP, params_from(pt.SECURITY_128_BIT_FAST)):
        ck = PK.CloudKey.generate_no_ksk(p, "cpu")
        g = p.trgsw_lv1
        assert ck.ksk_limbs.dtype == torch.int8
        assert tuple(ck.ksk_limbs.shape) == (p.n1 * g.iks_t * p.ks_base, 4 * PK.ksk_width(p))
        assert ck.bsk.dtype == torch.int32 and tuple(ck.bsk.shape) == (p.n0, 2 * g.l, 2, p.n1)
        assert not ck.ksk_limbs.any() and not ck.bsk.any() and ck.bsk_mb is None
        assert torch.equal(ck.testvec, PK.gen_testvec(p, "cpu"))
    jck = JCloudKey.generate_no_ksk(P)
    ck = PK.CloudKey.generate_no_ksk(PP, "cpu")
    np.testing.assert_array_equal(to_numpy(ck.bsk), np.asarray(jck.bsk))
    np.testing.assert_array_equal(to_numpy(ck.testvec), np.asarray(jck.testvec))


def test_generate_secure_keys_work(monkeypatch):
    """Two draws differ; each key pair encrypts, decrypts and evaluates a
    gate; every key bit, noise word and the cloud key's gen_seed (which
    seeds its masks) is read from the OS CSPRNG (the bytes asked of
    os.urandom cover them), and seeding torch's own generator does not
    repeat a key."""
    asked = []
    urandom = PTo.os.urandom
    monkeypatch.setattr(PTo.os, "urandom", lambda n: asked.append(n) or urandom(n))
    torch.manual_seed(0)
    sk1 = PK.SecretKey.generate_secure(PP, "cpu")
    assert sum(asked) == 4 * (PP.n0 + PP.n1)
    torch.manual_seed(0)
    sk2 = PK.SecretKey.generate_secure(PP, "cpu")
    assert not torch.equal(sk1.lv0, sk2.lv0) and not torch.equal(sk1.lv1, sk2.lv1)
    assert set(sk1.lv0.unique().tolist()) <= {0, 1} and sk1.lv0.dtype == torch.int32
    asked.clear()
    ck1 = PK.CloudKey.generate_secure(sk1, multibit=True)
    g = PP.trgsw_lv1
    ksk_rows, bsk_rows, mb_rows = PP.n1 * g.iks_t * PP.ks_base, PP.n0 * 2 * g.l, PP.n0 // 2 * 4 * 2 * g.l
    # gen_seed 8 bytes (its threefry streams make every mask word), noise 16
    # bytes a sample (two 64-bit uniforms)
    assert sum(asked) == 8 + ksk_rows * 16 + (bsk_rows + mb_rows) * 16 * PP.n1
    ck2 = PK.CloudKey.generate_secure(sk1)
    assert not torch.equal(ck1.bsk, ck2.bsk) and not torch.equal(ck1.ksk_limbs, ck2.ksk_limbs)
    gen = PTo.OsRandom("cpu")
    a = PT.lwe_encrypt_bool(gen, sk1.lv0, [True, False, True, False], PP.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(gen, sk1.lv0, [True, True, False, False], PP.tlwe_lv0.alpha)
    assert _dec(a, sk1).tolist() == [True, False, True, False]
    for ck in (ck1, ck2):
        assert _dec(PG.nand(a, b, ck), sk1).tolist() == [False, True, True, True]
    m = PT.lwe_encrypt_message(gen, sk1.lv0, [0, 1, 2, 3], 4, PP.tlwe_lv0.alpha)
    out = PB.LutBootstrap().bootstrap_func(m, lambda v: (v + 1) % 4, 4, ck1)
    assert PT.lwe_decrypt_message(out, sk1.lv0, 4).tolist() == [1, 2, 3, 0]


def test_os_random_distributions():
    """OsRandom's words are uniform 32-bit and its noise N(0, alpha) words
    truncated toward zero, like the torch.Generator path's."""
    gen = PTo.OsRandom("cpu")
    words = PTo.uniform_torus(gen, (1 << 16,))
    assert words.dtype == torch.int32 and words.min() < -(1 << 30) and words.max() > 1 << 30
    assert abs(float(words.double().mean())) < 2 ** 31 * 0.02
    alpha = 1e-3
    noise = PTo.gaussian_torus(gen, alpha, (1 << 16,))
    assert noise.dtype == torch.int32
    assert abs(float(noise.double().std()) / (alpha * 2 ** 32) - 1.0) < 0.03
    bits = PTo.uniform_bits(gen, 1 << 12)
    assert set(bits.unique().tolist()) == {0, 1} and abs(float(bits.double().mean()) - 0.5) < 0.05

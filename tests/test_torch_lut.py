"""PyTorch port: programmable bootstrapping (LUTs), the noise model, message
encryption and boolean TRLWE encryption, held against the JAX package.

The noise model returns the same floats as rs_tfhe_tpu/utils/noise.py for
every parameter set; LUT polynomials, encodings and trivial ciphertexts are
equal word for word; the programmable bootstrap with a JAX multi-bit key
carried across equals JAX's output at TEST_TINY (tolerance 0) at batches
that both packages route the same way, and decrypts correctly elsewhere."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import bootstrap as JB  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu import trlwe as JR  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.lut.encoder import Encoder as JEncoder  # noqa: E402
from rs_tfhe_tpu.lut.generator import Generator as JGenerator  # noqa: E402
from rs_tfhe_tpu.utils import noise as JN  # noqa: E402
from rs_tfhe_tpu_torch import bootstrap as PB  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import trlwe as PR  # noqa: E402
from rs_tfhe_tpu_torch.lut import Encoder, Generator, LookupTable  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402
from rs_tfhe_tpu_torch.utils import noise as PN  # noqa: E402

TINY, PTINY = JP.TEST_TINY, params_from(JP.TEST_TINY)
_SETS = {**JP.ALL_SECURITY_SETS, "TEST_TINY": JP.TEST_TINY}


@pytest.mark.parametrize("name", sorted(_SETS))
def test_noise_model_equals_jax(name):
    """estimate (standard and multi-bit), lut_margin and mb_lut_route_ok
    return the same floats (==, not approximately) as the JAX package."""
    jp = _SETS[name]
    pp = params_from(jp)
    for mb in (1, 2):
        got, ref = PN.estimate(pp, mb_group=mb), JN.estimate(jp, mb_group=mb)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.bits_of_margin() == ref.bits_of_margin()
    for modulus in (2, 4, 8, 16, 32):
        for kwargs in ({}, {"n_summands": 1, "mv_norm": 4.0}, {"mb_group": 2}):
            got = PN.lut_margin(pp, modulus, **kwargs)
            assert got == JN.lut_margin(jp, modulus, **kwargs)
            assert all(math.isfinite(x) for x in got)
    assert PN.mb_lut_route_ok(pp) == JN.mb_lut_route_ok(jp)
    with pytest.raises(ValueError, match="mb_group"):
        PN.estimate(pp, mb_group=3)


def test_mb_lut_route_policy_at_the_named_sets():
    """The policy the PBS path relies on: on at RADIX and NIBBLE, off at
    FAST and strict (rs_tfhe_tpu/utils/noise.py:201-216)."""
    assert PN.mb_lut_route_ok(params_from(JP.SECURITY_128_BIT_RADIX))
    assert PN.mb_lut_route_ok(params_from(JP.SECURITY_128_BIT_NIBBLE))
    assert not PN.mb_lut_route_ok(params_from(JP.SECURITY_128_BIT_FAST))
    assert not PN.mb_lut_route_ok(params_from(JP.SECURITY_128_BIT))


@pytest.mark.parametrize(
    "modulus,name", [(2, "SECURITY_128_BIT"), (4, "TEST_TINY"), (8, "SECURITY_128_BIT_RADIX"),
                     (16, "SECURITY_128_BIT_NIBBLE")]
)
def test_generator_luts_equal_jax(modulus, name):
    jp = _SETS[name]
    pg, jg = Generator(modulus, params_from(jp)), JGenerator(modulus, jp)
    for f in (lambda x: x, lambda x: (3 * x + 1) % modulus, lambda x: x * x):
        np.testing.assert_array_equal(to_numpy(pg.generate_lookup_table(f).poly),
                                      np.asarray(jg.generate_lookup_table(f).poly))
    full = lambda x: (x * 0x01000193) & 0xFFFFFFFF  # noqa: E731
    np.testing.assert_array_equal(to_numpy(pg.generate_lookup_table_full(full).poly),
                                  np.asarray(jg.generate_lookup_table_full(full).poly))
    custom = (lambda x: 1 - x, 2, 1.0 / 8.0)
    np.testing.assert_array_equal(to_numpy(pg.generate_lookup_table_custom(*custom).poly),
                                  np.asarray(jg.generate_lookup_table_custom(*custom).poly))
    for x in (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 123456789):
        assert pg.mod_switch(x) == jg.mod_switch(x)


def test_encoder_equals_jax():
    words = np.random.default_rng(80).integers(0, 1 << 32, 64, dtype=np.uint32)
    for modulus, scale in ((4, None), (16, None), (8, 1.0 / 32.0)):
        pe, je = Encoder(modulus, scale), JEncoder(modulus, scale)
        msgs = np.arange(-3, 2 * modulus)
        np.testing.assert_array_equal(pe.encode(msgs), je.encode(msgs))
        np.testing.assert_array_equal(pe.encode_with_scale(msgs, 0.01), je.encode_with_scale(msgs, 0.01))
        np.testing.assert_array_equal(pe.decode(words), je.decode(words))
        np.testing.assert_array_equal(pe.decode_bool(words), je.decode_bool(words))
    assert Encoder.with_scale(4, 0.125).scale == 0.125


def test_lookup_table_trlwe_conversions():
    poly = Generator(4, PTINY).generate_lookup_table(lambda x: x).poly
    lut = LookupTable.from_poly(poly)
    assert lut.as_trlwe() is poly and not lut.is_empty
    assert LookupTable(torch.zeros((2, PTINY.n1), dtype=torch.int32)).is_empty
    assert torch.equal(LookupTable.from_trlwe(poly).poly, poly)
    with pytest.raises(ValueError):
        LookupTable.from_trlwe(torch.zeros((3, PTINY.n1), dtype=torch.int32))
    with pytest.raises(TypeError):
        LookupTable.from_trlwe(torch.zeros((2, PTINY.n1), dtype=torch.int64))


@pytest.mark.parametrize("modulus", [2, 4, 8])
def test_message_encryption_round_trip(modulus):
    """The port's message encoding decrypts with both packages' decoders;
    trivial messages equal JAX's word for word."""
    g = torch.Generator().manual_seed(81)
    s = PK.SecretKey.generate(PTINY, g).lv0
    msgs = np.arange(-modulus, 3 * modulus)
    ct = PT.lwe_encrypt_message(g, s, msgs, modulus, PTINY.tlwe_lv0.alpha)
    expect = msgs % modulus
    np.testing.assert_array_equal(PT.lwe_decrypt_message(ct, s, modulus), expect)
    jdec = JT.lwe_decrypt_message(jnp.asarray(to_numpy(ct)), jnp.asarray(to_numpy(s)), modulus)
    np.testing.assert_array_equal(jdec, expect)
    trivial = PT.lwe_trivial_message(msgs, modulus, PTINY.n0)
    np.testing.assert_array_equal(to_numpy(trivial), np.asarray(JT.lwe_trivial_message(msgs, modulus, PTINY.n0)))
    np.testing.assert_array_equal(PT.lwe_decrypt_message(trivial, s, modulus), expect)


def test_jax_message_ciphertexts_decrypt_in_the_port():
    sk = JSecretKey.generate(jax.random.key(82), TINY)
    msgs = jnp.arange(8)
    ct = JT.lwe_encrypt_message(jax.random.key(83), sk.lv0, msgs, 8, TINY.tlwe_lv0.alpha)
    got = PT.lwe_decrypt_message(to_torch(np.asarray(ct)), to_torch(np.asarray(sk.lv0)), 8)
    np.testing.assert_array_equal(got, np.asarray(msgs))


def test_trlwe_bool_round_trip():
    """trlwe_encrypt_bool / trlwe_decrypt_bool in the port; the ciphertext
    also decrypts with the JAX package's trlwe_decrypt_bool."""
    g = torch.Generator().manual_seed(84)
    s1 = PK.SecretKey.generate(PTINY, g).lv1
    msg = torch.from_numpy(np.random.default_rng(85).integers(0, 2, (3, PTINY.n1)).astype(bool))
    ct = PR.trlwe_encrypt_bool(g, s1, msg, PTINY.trlwe_lv1.alpha)
    assert torch.equal(PR.trlwe_decrypt_bool(ct, s1), msg)
    jdec = JR.trlwe_decrypt_bool(jnp.asarray(to_numpy(ct)), jnp.asarray(to_numpy(s1)))
    np.testing.assert_array_equal(np.asarray(jdec), msg.numpy())


# ---------------------------------------------------------------------------
# Programmable bootstrapping with a JAX multi-bit key carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keys():
    sk = JSecretKey.generate(jax.random.key(90), TINY)
    ck = JCloudKey.generate(jax.random.key(91), sk, multibit=True)
    arrays = {
        "lv0": np.asarray(sk.lv0), "lv1": np.asarray(sk.lv1), "testvec": np.asarray(ck.testvec),
        "bsk": np.asarray(ck.bsk), "ksk_limbs": np.asarray(ck.ksk_limbs), "bsk_mb": np.asarray(ck.bsk_mb),
    }
    msgs = np.random.default_rng(92).integers(0, 4, 8)
    jct = JT.lwe_encrypt_message(jax.random.key(93), sk.lv0, jnp.asarray(msgs), 4, TINY.tlwe_lv0.alpha)
    return dict(jsk=sk, jck=ck, psk=PK.secret_key_from_numpy(arrays, PTINY),
                pck=PK.cloud_key_from_numpy(arrays, PTINY), msgs=msgs, jct=jct,
                pct=to_torch(np.asarray(jct)))


@pytest.mark.parametrize("allow_mb", [None, True, False], ids=["policy", "mb", "standard"])
def test_bootstrap_with_testvec_equals_jax(keys, allow_mb):
    """B=2 (both packages route multi-bit when allowed) and B=8 with the
    standard route: equal to JAX; the multi-bit route at B=8, where JAX's
    cap (4) and the port's differ, decrypts correctly."""
    lut = JGenerator(4, TINY).generate_lookup_table(lambda x: (x + 1) % 4).poly
    plut = to_torch(np.asarray(lut))
    jck, pck, pct, jct = keys["jck"], keys["pck"], keys["pct"], keys["jct"]
    ref = np.asarray(JB.bootstrap_with_testvec(jct[:2], lut, jck, allow_mb=allow_mb))
    np.testing.assert_array_equal(to_numpy(PB.bootstrap_with_testvec(pct[:2], plut, pck, allow_mb=allow_mb)), ref)
    out = PB.bootstrap_with_testvec(pct, plut, pck, allow_mb=allow_mb)
    if allow_mb is False:
        np.testing.assert_array_equal(to_numpy(out), np.asarray(JB.bootstrap_with_testvec(jct, lut, jck, allow_mb=False)))
    np.testing.assert_array_equal(PT.lwe_decrypt_message(out, keys["psk"].lv0, 4), (keys["msgs"] + 1) % 4)


def test_bootstrap_with_per_ciphertext_luts_equals_jax(keys):
    gen = JGenerator(4, TINY)
    fs = [lambda x: (3 * x) % 4, lambda x: (x * x) % 4]
    lut = jnp.stack([gen.generate_lookup_table(f).poly for f in fs])
    ref = np.asarray(JB.bootstrap_with_testvec(keys["jct"][:2], lut, keys["jck"], allow_mb=True))
    out = PB.bootstrap_with_testvec(keys["pct"][:2], to_torch(np.asarray(lut)), keys["pck"], allow_mb=True)
    np.testing.assert_array_equal(to_numpy(out), ref)
    expect = [f(m) for f, m in zip(fs, keys["msgs"][:2])]
    np.testing.assert_array_equal(PT.lwe_decrypt_message(out, keys["psk"].lv0, 4), expect)


def test_lut_bootstrap_strategy_equals_jax(keys):
    """LutBootstrap.bootstrap_func / bootstrap / bootstrap_gate /
    bootstrap_without_key_switch at B=2 against the JAX strategy."""
    jct, pct, jck, pck = keys["jct"][:2], keys["pct"][:2], keys["jck"], keys["pck"]
    f = lambda x: (2 * x + 3) % 4  # noqa: E731
    pl, jl = PB.LutBootstrap(), JB.LutBootstrap()
    out = pl.bootstrap_func(pct, f, 4, pck)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(jl.bootstrap_func(jct, f, 4, jck)))
    np.testing.assert_array_equal(PT.lwe_decrypt_message(out, keys["psk"].lv0, 4), f(keys["msgs"][:2]))
    np.testing.assert_array_equal(to_numpy(pl.bootstrap(pct, pck)), np.asarray(jl.bootstrap(jct, jck)))
    np.testing.assert_array_equal(to_numpy(pl.bootstrap_gate(pct, pck)), np.asarray(jl.bootstrap_gate(jct, jck)))
    np.testing.assert_array_equal(to_numpy(pl.bootstrap_without_key_switch(pct, pck)),
                                  np.asarray(jl.bootstrap_without_key_switch(jct, jck)))


def test_lut_cache_is_bounded_and_reused(keys):
    pl, pck, ct = PB.LutBootstrap(), keys["pck"], keys["pct"][:1]
    f = lambda x: x  # noqa: E731
    pl.bootstrap_func(ct, f, 4, pck)
    (cached,) = pl._lut_cache.values()
    pl.bootstrap_func(ct, f, 4, pck)
    assert len(pl._lut_cache) == 1 and next(iter(pl._lut_cache.values())) is cached
    for k in range(PB.LutBootstrap._LUT_CACHE_MAX + 2):
        pl.bootstrap_func(ct, lambda x, k=k: (x + k) % 4, 4, pck)
    assert len(pl._lut_cache) == PB.LutBootstrap._LUT_CACHE_MAX
    assert all(lut.poly.device == pck.testvec.device for lut in pl._lut_cache.values())

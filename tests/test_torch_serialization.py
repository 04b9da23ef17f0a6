"""PyTorch port: `utils/serialization` against the JAX package's key files at
TEST_TINY, both ways and bit for bit: secret, full and seeded cloud keys
(standard and multi-bit), and re-encryption keys. A file either package
writes loads in the other to the same arrays (the limb tables converted
between the JAX layout on disk and the port's), and a gate on each loaded
key decrypts correctly."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import proxy_reenc as JPR  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.utils import serialization as JS  # noqa: E402
from rs_tfhe_tpu_torch import gates as PG  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import proxy_reenc as PPR  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy  # noqa: E402
from rs_tfhe_tpu_torch.utils import serialization as PS  # noqa: E402


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
BITS_A = np.asarray([True, True, False, False])
BITS_B = np.asarray([True, False, True, False])


@pytest.fixture(scope="module")
def keys():
    """JAX keys (a standard and a multi-bit cloud key), the port's secret key
    from the same arrays, and the port's own keys generated on it."""
    jsk = JSecretKey.generate(jax.random.key(501), TINY)
    jck_mb = JCloudKey.generate(jax.random.key(503), jsk, multibit=True)
    # the same key without its multi-bit part: what generate(multibit=False) makes from that seed
    jck = {False: dataclasses.replace(jck_mb, bsk_mb=None, bsk_mb_vecs=None), True: jck_mb}
    psk = PK.secret_key_from_numpy({"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1)}, PTINY, "cpu")
    g = torch.Generator().manual_seed(504)
    pck = {mb: PK.CloudKey.generate(psk, g, multibit=mb) for mb in (False, True)}
    return jsk, jck, psk, pck


def _jax_arrays(jck) -> dict:
    names = ("testvec", "bsk", "ksk_limbs", "bsk_mb", "gen_seed")
    return {k: np.asarray(getattr(jck, k)) for k in names if getattr(jck, k) is not None}


def _assert_same_key(port: PK.CloudKey, ref: PK.CloudKey) -> None:
    for name in ("testvec", "bsk", "ksk_limbs", "bsk_mb", "gen_seed"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def _port_nand_ok(psk, ck) -> None:
    g = torch.Generator().manual_seed(9)
    a = PT.lwe_encrypt_bool(g, psk.lv0, BITS_A, PTINY.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, psk.lv0, BITS_B, PTINY.tlwe_lv0.alpha)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(PG.nand(a, b, ck), psk.lv0).numpy(), ~(BITS_A & BITS_B))


@pytest.mark.parametrize("multibit", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_jax_cloud_key_files_load_in_the_port(keys, tmp_path, seeded, multibit):
    jsk, jck, psk, _ = keys
    path = tmp_path / "ck.npz"
    JS.save_cloud_key(path, jck[multibit], seeded=seeded)
    loaded = PS.load_cloud_key(path, "cpu")
    arrays = _jax_arrays(jck[multibit])
    if not seeded:
        arrays.pop("gen_seed")  # a full file does not carry it, in either package
    _assert_same_key(loaded, PK.cloud_key_from_numpy(arrays, PTINY, "cpu"))
    assert loaded.params == PTINY
    _port_nand_ok(psk, loaded)


@pytest.mark.parametrize("multibit", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_port_cloud_key_files_load_in_jax(keys, tmp_path, seeded, multibit):
    _, _, psk, pck = keys
    ck = pck[multibit]
    path = tmp_path / "ck.npz"
    PS.save_cloud_key(path, ck, seeded=seeded)
    jloaded = JS.load_cloud_key(path)
    assert jloaded.params == TINY
    np.testing.assert_array_equal(np.asarray(jloaded.bsk), to_numpy(ck.bsk))
    np.testing.assert_array_equal(np.asarray(jloaded.testvec), to_numpy(ck.testvec))
    np.testing.assert_array_equal(np.asarray(jloaded.ksk_limbs), PS._jax_limbs(ck.ksk_limbs, PTINY.n0 + 1))
    back = PK.cloud_key_from_numpy(_jax_arrays(jloaded), PTINY, "cpu")
    _assert_same_key(back, ck if seeded else PK.CloudKey(ck.testvec, ck.bsk, ck.ksk_limbs, PTINY, ck.bsk_mb))
    if multibit:
        np.testing.assert_array_equal(np.asarray(jloaded.bsk_mb), to_numpy(ck.bsk_mb))
    else:
        assert jloaded.bsk_mb is None
    _port_nand_ok(psk, back)


@pytest.mark.parametrize("multibit", [False, True])
def test_port_round_trip_full_and_seeded(keys, tmp_path, multibit):
    _, _, psk, pck = keys
    ck = pck[multibit]
    PS.save_cloud_key(tmp_path / "full.npz", ck)
    PS.save_cloud_key(tmp_path / "seeded.npz", ck, seeded=True)
    _assert_same_key(PS.load_cloud_key(tmp_path / "seeded.npz", "cpu"), ck)
    full = PS.load_cloud_key(tmp_path / "full.npz", "cpu")
    assert full.gen_seed is None
    _assert_same_key(full, PK.CloudKey(ck.testvec, ck.bsk, ck.ksk_limbs, PTINY, ck.bsk_mb))
    _port_nand_ok(psk, full)
    with np.load(tmp_path / "seeded.npz", allow_pickle=False) as z:
        expect = {"version", "kind", "params", "prng_impl", "gen_seed", "ksk_bodies", "bsk_bodies", "bsk_mask0"}
        assert set(z.files) == expect | ({"mb_bodies", "mb_mask0"} if multibit else set())
    assert (tmp_path / "seeded.npz").stat().st_size < (tmp_path / "full.npz").stat().st_size


def test_secret_key_files_cross_both_ways(keys, tmp_path):
    jsk, _, psk, _ = keys
    JS.save_secret_key(tmp_path / "j.npz", jsk)
    loaded = PS.load_secret_key(tmp_path / "j.npz", "cpu")
    assert torch.equal(loaded.lv0, psk.lv0) and torch.equal(loaded.lv1, psk.lv1) and loaded.params == PTINY
    other = PK.SecretKey.generate(PTINY, torch.Generator().manual_seed(12))
    PS.save_secret_key(tmp_path / "p.npz", other)
    jloaded = JS.load_secret_key(tmp_path / "p.npz")
    np.testing.assert_array_equal(np.asarray(jloaded.lv0), to_numpy(other.lv0))
    np.testing.assert_array_equal(np.asarray(jloaded.lv1), to_numpy(other.lv1))


def test_reenc_key_files_cross_both_ways(keys, tmp_path):
    jsk, _, psk, _ = keys
    jbob = JSecretKey.generate(jax.random.key(505), TINY)
    jrk = JPR.new_symmetric(jax.random.key(506), jsk.lv0, jbob.lv0, TINY)
    JS.save_reenc_key(tmp_path / "j.npz", jrk)
    prk = PS.load_reenc_key(tmp_path / "j.npz", "cpu")
    assert (prk.basebit, prk.t, prk.params) == (jrk.basebit, jrk.t, PTINY)
    np.testing.assert_array_equal(PS._jax_limbs(prk.table_limbs, PTINY.n0 + 1), np.asarray(jrk.table_limbs))
    g = torch.Generator().manual_seed(13)
    bob = PK.SecretKey.generate(PTINY, g)
    mine = PPR.new_symmetric(g, psk.lv0, bob.lv0, PTINY)
    PS.save_reenc_key(tmp_path / "p.npz", mine)
    jloaded = JS.load_reenc_key(tmp_path / "p.npz")
    assert (jloaded.basebit, jloaded.t) == (mine.basebit, mine.t)
    np.testing.assert_array_equal(np.asarray(jloaded.table_limbs), PS._jax_limbs(mine.table_limbs, PTINY.n0 + 1))
    ct = PT.lwe_encrypt_bool(g, psk.lv0, BITS_A, PTINY.tlwe_lv0.alpha)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(PPR.reencrypt(ct, PS.load_reenc_key(tmp_path / "p.npz", "cpu")),
                                                      bob.lv0).numpy(), BITS_A)


def test_seeded_save_needs_a_gen_seed(keys, tmp_path):
    """As in the JAX package (rs_tfhe_tpu/utils/serialization.py:83-84): a
    key loaded from a full file, or a dummy key, has no gen_seed."""
    _, _, _, pck = keys
    PS.save_cloud_key(tmp_path / "full.npz", pck[False])
    for ck in (PS.load_cloud_key(tmp_path / "full.npz", "cpu"), PK.CloudKey.generate_no_ksk(PTINY, "cpu")):
        with pytest.raises(ValueError, match="gen_seed"):
            PS.save_cloud_key(tmp_path / "seeded.npz", ck, seeded=True)


def test_loaders_reject_other_kinds_versions_and_streams(keys, tmp_path):
    _, _, psk, pck = keys
    PS.save_cloud_key(tmp_path / "ck.npz", pck[False], seeded=True)
    PS.save_secret_key(tmp_path / "sk.npz", psk)
    with pytest.raises(ValueError, match="expected a secret key"):
        PS.load_secret_key(tmp_path / "ck.npz", "cpu")
    with pytest.raises(ValueError, match="expected a cloud key"):
        PS.load_cloud_key(tmp_path / "sk.npz", "cpu")
    with pytest.raises(ValueError, match="expected a reenc key"):
        PS.load_reenc_key(tmp_path / "ck.npz", "cpu")
    with np.load(tmp_path / "ck.npz", allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    np.savez_compressed(tmp_path / "v3.npz", **{**arrays, "version": 3})
    with pytest.raises(ValueError, match="version 3"):
        PS.load_cloud_key(tmp_path / "v3.npz", "cpu")
    with pytest.raises(ValueError, match="version 3"):
        JS.load_cloud_key(tmp_path / "v3.npz")
    np.savez_compressed(tmp_path / "philox.npz", **{**arrays, "prng_impl": "philox4x32"})
    with pytest.raises(ValueError, match="prng_impl"):
        PS.load_cloud_key(tmp_path / "philox.npz", "cpu")


def test_loaders_default_to_the_card(keys, tmp_path):
    """device=None means the card: without one the loaders raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, psk, pck = keys
    PS.save_cloud_key(tmp_path / "ck.npz", pck[False], seeded=True)
    PS.save_secret_key(tmp_path / "sk.npz", psk)
    for load, name in ((PS.load_cloud_key, "ck.npz"), (PS.load_secret_key, "sk.npz")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(tmp_path / name)

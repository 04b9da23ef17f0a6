"""PyTorch port: the multi-bit (pair-grouped) blind rotation and key.

The port's plain multi-bit rotation, the function of its CUDA kernel
(csrc/blind_rotate_mb.cu), is held bit-exact (tolerance 0) against the JAX
package's XLA path `blind_rotate_mb` and against the TPU kernel K4
`fused_blind_rotate_small_mb` in interpret mode, fed from one numpy seed, as
tests/test_pallas_kernels.py holds K4 against the XLA path. Gates with a JAX
multi-bit key carried across are held against JAX below and above the
route's batch cap; the port's own multi-bit keygen is checked by truth table,
stream identity and the noise model. The kernel itself is held against the
plain version on the card in tests/test_torch_kernel_gpu.py; its instance
plan is checked here without the card."""

import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import bootstrap as JBS  # noqa: E402
from rs_tfhe_tpu import gates as JGa  # noqa: E402
from rs_tfhe_tpu.config import config as JCONFIG  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.key import round_bsk  # noqa: E402
from rs_tfhe_tpu.ops import blind_rotate as JBR  # noqa: E402
from rs_tfhe_tpu.ops.pallas_blind_rotate import (  # noqa: E402
    fused_blind_rotate_small_mb,
    mb_rows_per_pattern,
    prepare_bsk_mb_vecs,
)
from rs_tfhe_tpu_torch import bootstrap as PBS  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import gates as PGa  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate_mb as CMB  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.trlwe import trlwe_phase  # noqa: E402
from rs_tfhe_tpu_torch.torus import f64_to_torus, to_numpy, to_torch  # noqa: E402
from rs_tfhe_tpu_torch.utils.noise import estimate, measure_phase_noise  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the smallest K4-eligible set of tests/test_pallas_kernels.py (N = 128)
KP = JP.TfheParams(
    security_bits=0,
    description="kernel-eligible tiny set",
    tlwe_lv0=JP.TlweParams(n=8, alpha=1.0e-9),
    tlwe_lv1=JP.TlweParams(n=128, alpha=1.0e-12),
    trlwe_lv1=JP.TrlweParams(n=128, alpha=1.0e-12),
    trgsw_lv1=JP.TrgswParams(n=128, nbit=7, bgbit=6, l=2, basebit=2, iks_t=8, alpha=1.0e-12),
)
TINY, PTINY = JP.TEST_TINY, params_from(JP.TEST_TINY)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = np.array([False, False, True, True] * 2)
B = np.array([False, True, False, True] * 2)


@pytest.fixture
def impl():
    """Set config.step_impl for one test and restore it afterwards."""
    saved = PC.config.step_impl
    yield lambda value: setattr(PC.config, "step_impl", value)
    PC.config.step_impl = saved


@pytest.mark.parametrize(
    "batch,per_ct_tv,rounded",
    [(1, False, False), (2, False, False), (2, True, True)],
    ids=["b1_shared", "b2_shared", "b2_per_ct_tv_24bit_key"],
)
def test_plain_mb_matches_jax_xla_and_k4(batch, per_ct_tv, rounded):
    """The port's plain multi-bit rotation == JAX `blind_rotate_mb` (XLA
    path) == K4 `fused_blind_rotate_small_mb` in interpret mode; the 24-bit
    case runs K4 with drop_limbs=1 (its zero low limb plane skipped)."""
    p = dataclasses.replace(KP, bsk_round_bits=8) if rounded else KP
    rng = np.random.default_rng(40 + batch + 10 * rounded)
    n0, n1 = p.n0, p.n1
    bsk_mb = jnp.asarray(rng.integers(0, 1 << 32, (n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, n1), dtype=np.uint32))
    if rounded:
        bsk_mb = round_bsk(bsk_mb, 8)
    ct = jnp.asarray(rng.integers(0, 1 << 32, (batch, n0 + 1), dtype=np.uint32))
    tv = jnp.asarray(rng.integers(0, 1 << 32, (batch, 2, n1) if per_ct_tv else (2, n1), dtype=np.uint32))
    xla = np.asarray(JBR.blind_rotate_mb(ct, tv, bsk_mb, p))
    b_til = ((2 * n1 - JBR.modswitch(ct[:, n0], p)) % (2 * n1)).astype(jnp.int32)
    a_til = JBR.modswitch(ct[:, :n0], p)
    drop = int(rounded)
    k4 = fused_blind_rotate_small_mb(
        b_til, JBR._mb_k_rows(a_til[:, 0::2], a_til[:, 1::2], p, mb_rows_per_pattern(p, drop)),
        tv, prepare_bsk_mb_vecs(bsk_mb, drop_limbs=drop), p, interpret=True, drop_limbs=drop,
    )
    pb, pa = PBR.rotation_exponents(to_torch(np.asarray(ct), "cpu"), params_from(p))
    port = PBR.blind_rotate_mb_plain(pb, pa, to_torch(np.asarray(tv), "cpu"), to_torch(np.asarray(bsk_mb), "cpu"), params_from(p))
    np.testing.assert_array_equal(to_numpy(port), xla)
    np.testing.assert_array_equal(to_numpy(port), np.asarray(k4))


@pytest.mark.parametrize("name", sorted(JP.ALL_SECURITY_SETS))
def test_mb_route_batch_cap_matches_jax(name):
    """The port's cap is its own copy of the JAX package's: 2 at L=2, 4 at
    L>=3 (rs_tfhe_tpu/ops/blind_rotate.py:49-56)."""
    jp = JP.ALL_SECURITY_SETS[name]
    assert PBR.mb_route_batch_cap(params_from(jp)) == JBR.mb_route_batch_cap(jp)


def test_blind_rotate_routes_by_batch_and_step_impl(impl):
    """`blind_rotate` with a multi-bit key routes as the JAX package does
    (rs_tfhe_tpu/ops/blind_rotate.py:242-249): under "auto" the multi-bit
    rotation up to `mb_route_batch_cap` (4 at TEST_TINY, L=3) and the
    standard one above it; "fused_small_mb" forces the multi-bit rotation at
    every batch and, given a key without `bsk_mb`, takes the standard one, as
    the JAX package falls through to its CMUX scan; "pallas" and a key
    without `bsk_mb` take the standard rotation."""
    assert PBR.mb_route_batch_cap(PTINY) == 4
    rng = np.random.default_rng(50)
    l = PTINY.trgsw_lv1.l
    bsk = to_torch(rng.integers(0, 1 << 32, (PTINY.n0, 2 * l, 2, PTINY.n1), dtype=np.uint32), "cpu")
    bsk_mb = to_torch(rng.integers(0, 1 << 32, (PTINY.n0 // 2, 4, 2 * l, 2, PTINY.n1), dtype=np.uint32), "cpu")
    tv = to_torch(rng.integers(0, 1 << 32, (2, PTINY.n1), dtype=np.uint32), "cpu")
    ct = to_torch(rng.integers(0, 1 << 32, (9, PTINY.n0 + 1), dtype=np.uint32), "cpu")
    b_til, a_til = PBR.rotation_exponents(ct, PTINY)
    mb = PBR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, PTINY)
    std = PBR.blind_rotate_plain(b_til, a_til, tv, bsk, PTINY)
    assert not torch.equal(mb, std)  # random keys: the two functions differ
    for batch in (1, 4):
        assert torch.equal(PBR.blind_rotate(ct[:batch], tv, bsk, PTINY, bsk_mb=bsk_mb), mb[:batch])
    for batch in (5, 9):
        assert torch.equal(PBR.blind_rotate(ct[:batch], tv, bsk, PTINY, bsk_mb=bsk_mb), std[:batch])
    assert torch.equal(PBR.blind_rotate(ct, tv, bsk, PTINY), std)
    impl("pallas")
    assert torch.equal(PBR.blind_rotate(ct[:1], tv, bsk, PTINY, bsk_mb=bsk_mb), std[:1])
    impl("fused_small_mb")
    assert torch.equal(PBR.blind_rotate(ct, tv, bsk, PTINY, bsk_mb=bsk_mb), mb)
    assert torch.equal(PBR.blind_rotate(ct, tv, bsk, PTINY), std)


def test_mb_kernel_plan_small_batches():
    """The multi-bit kernel's plan (`cuda_blind_rotate_mb.rotation_instance`)
    for batches 1..16 with an H100's cluster slots, at the ring sizes with
    cluster instances: a tile the instance has, one wave, a cluster of 16
    SMs per ciphertext at the batches "auto" sends (at most 4); and the
    single-block instance where clusters no longer fill the card in one wave."""
    slots = CBR.H100_CLUSTER_SLOTS
    for n, max_tile, max_cluster_tile in ((64, 4, 4), (1024, 4, 4), (2048, 2, 4), (4096, 1, 1)):
        ring_slots = {c: h for c, h in slots.items() if c <= (8 if n == 64 else 16)}
        for batch in range(1, 17):
            tile, cluster = CMB.rotation_instance(batch, ring_slots, n, max_tile, max_cluster_tile)
            assert tile in CMB.TILES and cluster in ring_slots and cluster > 1
            assert tile <= max_cluster_tile
            assert -(-batch // tile) <= ring_slots[cluster], (n, batch)
            if batch <= 4:
                assert (tile, cluster) == (1, 16 if n >= 1024 else 8)
    # a ring size without cluster instances: single blocks
    assert CMB.rotation_instance(3, {1: 132}, 512, 4, 0) == (1, 1)


@pytest.mark.parametrize("value", ["fused", "fused_small", "fused_wide", "fused_tile"])
def test_unported_step_impl_raises(impl, value):
    impl(value)
    with pytest.raises(ValueError, match="not ported"):
        PBR.blind_rotate(torch.zeros((1, PTINY.n0 + 1), dtype=torch.int32), PK.gen_testvec(PTINY, "cpu"),
                         torch.zeros((PTINY.n0, 2 * PTINY.trgsw_lv1.l, 2, PTINY.n1), dtype=torch.int32), PTINY)


def test_step_impl_reads_environment():
    """RS_TFHE_STEP_IMPL sets the route at import, as rs_tfhe_tpu/config.py:43."""
    code = (
        "from rs_tfhe_tpu_torch import config; "
        "assert config.config.step_impl == 'pallas'; assert config.step_impl() == 'pallas'; print('ok')"
    )
    env = {**os.environ, "RS_TFHE_STEP_IMPL": "pallas", "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_mb_kernel_wrapper_takes_cuda_tensors_only():
    p = PTINY
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        CMB.blind_rotate_mb_kernel(
            z(2, dtype=torch.int32), z(2, p.n0, dtype=torch.int32), z(2, p.n1, dtype=torch.int32),
            z(p.n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, p.n1, dtype=torch.int32), p,
        )


# ---------------------------------------------------------------------------
# Keys and gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mb():
    """A JAX multi-bit key at TEST_TINY and the same key in the port."""
    sk = JSecretKey.generate(jax.random.key(61), TINY)
    ck = JCloudKey.generate(jax.random.key(62), sk, multibit=True)
    arrays = {
        "lv0": np.asarray(sk.lv0), "lv1": np.asarray(sk.lv1), "testvec": np.asarray(ck.testvec),
        "bsk": np.asarray(ck.bsk), "ksk_limbs": np.asarray(ck.ksk_limbs), "bsk_mb": np.asarray(ck.bsk_mb),
    }
    return sk, ck, PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")


def test_cloud_key_from_numpy_carries_bsk_mb(jax_mb):
    _, jck, _, pck = jax_mb
    np.testing.assert_array_equal(to_numpy(pck.bsk_mb), np.asarray(jck.bsk_mb))
    bad = {"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk),
           "ksk_limbs": np.asarray(jck.ksk_limbs), "bsk_mb": np.asarray(jck.bsk_mb)[:-1]}
    with pytest.raises(ValueError, match="bsk_mb"):
        PK.cloud_key_from_numpy(bad, PTINY, "cpu")
    bad["bsk_mb"] = None
    assert PK.cloud_key_from_numpy(bad, PTINY, "cpu").bsk_mb is None


@pytest.mark.parametrize("gate", ["nand", "xor"])
def test_mb_gates_match_jax_with_carried_key(jax_mb, gate):
    """Both packages route a multi-bit key alike: B=2 through the multi-bit
    rotation (up to the cap, 4 at L=3), B=8 through the standard rotation —
    bit-exact at both, and every output decrypts to the truth table."""
    jsk, jck, psk, pck = jax_mb
    keys = jax.random.split(jax.random.key(63), 2)
    ja = JT.lwe_encrypt_bool(keys[0], jsk.lv0, jnp.asarray(A), TINY.tlwe_lv0.alpha)
    jb = JT.lwe_encrypt_bool(keys[1], jsk.lv0, jnp.asarray(B), TINY.tlwe_lv0.alpha)
    pa, pb = to_torch(np.asarray(ja), "cpu"), to_torch(np.asarray(jb), "cpu")
    ref = np.asarray(getattr(JGa, gate)(ja[:2], jb[:2], jck))
    np.testing.assert_array_equal(to_numpy(getattr(PGa, gate)(pa[:2], pb[:2], pck)), ref)
    assert len(A) > PBR.mb_route_batch_cap(PTINY)
    out = getattr(PGa, gate)(pa, pb, pck)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(getattr(JGa, gate)(ja, jb, jck)))
    truth = {"nand": ~(A & B), "xor": A ^ B}[gate]
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, psk.lv0).numpy(), truth)


def test_mb_mux_matches_jax_with_carried_key(jax_mb):
    jsk, jck, psk, pck = jax_mb
    bits = np.random.default_rng(64).integers(0, 2, (3, 2)).astype(bool)
    keys = jax.random.split(jax.random.key(65), 3)
    jc = [JT.lwe_encrypt_bool(k, jsk.lv0, jnp.asarray(m), TINY.tlwe_lv0.alpha) for k, m in zip(keys, bits)]
    out = PGa.mux(*(to_torch(np.asarray(c), "cpu") for c in jc), pck)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(JGa.mux(*jc, jck)))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, psk.lv0).numpy(), np.where(bits[0], bits[1], bits[2]))


@pytest.fixture
def both_fused_small_mb():
    """step_impl="fused_small_mb" in both packages for one test."""
    saved = PC.config.step_impl, JCONFIG.step_impl
    PC.config.step_impl = JCONFIG.step_impl = "fused_small_mb"
    yield
    PC.config.step_impl, JCONFIG.step_impl = saved


def test_fused_small_mb_without_multibit_key_matches_jax(jax_mb, both_fused_small_mb):
    """Under "fused_small_mb" a call with no multi-bit key takes the
    standard rotation in both packages (rs_tfhe_tpu/ops/blind_rotate.py:
    242-249 falls through to the CMUX scan): NAND with a standard key, and
    `bootstrap_with_testvec(allow_mb=False)` with a multi-bit key, each
    bit-equal to JAX and to the standard rotation under "auto"."""
    jsk, jck_mb, psk, pck_mb = jax_mb
    jck = JCloudKey.generate(jax.random.key(62), jsk)
    pck = PK.cloud_key_from_numpy({"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk),
                                   "ksk_limbs": np.asarray(jck.ksk_limbs)}, PTINY, "cpu")
    keys = jax.random.split(jax.random.key(66), 2)
    ja = JT.lwe_encrypt_bool(keys[0], jsk.lv0, jnp.asarray(A[:2]), TINY.tlwe_lv0.alpha)
    jb = JT.lwe_encrypt_bool(keys[1], jsk.lv0, jnp.asarray(B[:2]), TINY.tlwe_lv0.alpha)
    pa, pb = to_torch(np.asarray(ja), "cpu"), to_torch(np.asarray(jb), "cpu")
    out = PGa.nand(pa, pb, pck)
    np.testing.assert_array_equal(to_numpy(out), np.asarray(JGa.nand(ja, jb, jck)))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, psk.lv0).numpy(), ~(A[:2] & B[:2]))
    lut = np.random.default_rng(67).integers(0, 1 << 32, (2, PTINY.n1), dtype=np.uint32)
    ref = np.asarray(JBS.bootstrap_with_testvec(ja, jnp.asarray(lut), jck_mb, allow_mb=False))
    got = PBS.bootstrap_with_testvec(pa, to_torch(lut, "cpu"), pck_mb, allow_mb=False)
    np.testing.assert_array_equal(to_numpy(got), ref)
    PC.config.step_impl = "auto"
    assert torch.equal(PGa.nand(pa, pb, pck), out)
    assert torch.equal(PBS.bootstrap_with_testvec(pa, to_torch(lut, "cpu"), pck_mb, allow_mb=False), got)


@pytest.fixture(scope="module")
def port_mb():
    sk = PK.SecretKey.generate(PTINY, torch.Generator().manual_seed(70))
    std = PK.CloudKey.generate(sk, torch.Generator().manual_seed(71))
    mb = PK.CloudKey.generate(sk, torch.Generator().manual_seed(71), multibit=True)
    return sk, std, mb


def test_port_mb_keygen_keeps_the_standard_streams(port_mb):
    """multibit=True draws the multi-bit key after the KSK and BSK, so they
    equal those of a multibit=False key from an equally seeded generator
    (as tests/test_multibit.py:39 holds the JAX package)."""
    _, std, mb = port_mb
    assert torch.equal(std.bsk, mb.bsk) and torch.equal(std.ksk_limbs, mb.ksk_limbs)
    assert std.bsk_mb is None
    g = PTINY.trgsw_lv1
    assert tuple(mb.bsk_mb.shape) == (PTINY.n0 // 2, 4, 2 * g.l, 2, PTINY.n1)


def test_port_mb_key_encrypts_the_pair_indicators(port_mb):
    """Each pattern TRGSW's gadget row L (the first b-polynomial row) decrypts
    to the pattern's pair indicator times 2^(32 - bgbit) at coefficient 0."""
    sk, _, mb = port_mb
    s1, s2 = sk.lv0[0::2], sk.lv0[1::2]
    inds = torch.stack([(1 - s1) * (1 - s2), s1 * (1 - s2), (1 - s1) * s2, s1 * s2], dim=1)
    assert torch.equal(inds.sum(1), torch.ones_like(s1))
    g = PTINY.trgsw_lv1
    ph = trlwe_phase(mb.bsk_mb[:, :, g.l], sk.lv1)[..., 0]
    expect = inds * (1 << (32 - g.bgbit))
    err = (ph - expect).abs()
    assert int(err.max()) < 1 << 16


@pytest.mark.parametrize("name", ["nand", "and", "or", "xor"])
def test_port_mb_keygen_truth_table(port_mb, name):
    sk, _, mb = port_mb
    g = torch.Generator().manual_seed(72)
    a = PT.lwe_encrypt_bool(g, sk.lv0, A, PTINY.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, sk.lv0, B, PTINY.tlwe_lv0.alpha)
    fn = {"and": PGa.and_, "or": PGa.or_}.get(name) or getattr(PGa, name)
    truth = {"nand": ~(A & B), "and": A & B, "or": A | B, "xor": A ^ B}[name]
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(fn(a[:2], b[:2], mb), sk.lv0).numpy(), truth[:2])
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(fn(a, b, mb), sk.lv0).numpy(), truth)


def test_port_mb_noise_within_model(port_mb):
    """Empirical multi-bit bootstrap noise obeys estimate(mb_group=2), as
    tests/test_multibit.py:94 checks the JAX package."""
    sk, _, mb = port_mb
    est = estimate(PTINY, mb_group=2)
    g = torch.Generator().manual_seed(73)
    bits = np.random.default_rng(74).integers(0, 2, 64).astype(bool)
    a = PT.lwe_encrypt_bool(g, sk.lv0, bits, PTINY.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, sk.lv0, ~bits, PTINY.tlwe_lv0.alpha)
    lin = PGa._nand_lin(a, b)
    b_til, a_til = PBR.rotation_exponents(lin, PTINY)
    acc = PBR.blind_rotate_mb_plain(b_til, a_til, mb.testvec, mb.bsk_mb, PTINY)
    out = identity_key_switch(sample_extract(acc, 0), mb.ksk_limbs, PTINY)
    noise = measure_phase_noise(out, sk.lv0, np.uint32(f64_to_torus(0.125)))
    assert np.abs(noise).max() < 6.0 * est.bootstrap_out_std + 1e-9
    assert noise.std() < 2.0 * est.bootstrap_out_std + 1e-9
    assert est.bootstrap_out_std >= estimate(PTINY).bootstrap_out_std

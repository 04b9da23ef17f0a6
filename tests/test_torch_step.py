"""PyTorch port: the external-product step (the function of the CUDA kernel
csrc/external_product.cu), the per-step rotation behind
step_impl="pallas", and the exact plain product for digits wider than 8 bits.

The plain product is held bit-exact (tolerance 0) against the TPU kernel K5
`fused_external_product` in interpret mode, as tests/test_pallas_kernels.py
holds K5 against the XLA path, and against the JAX package's multi-limb
product at every Uint parameter set; the per-step rotation equals the
default one; the plain rotation and bootstrap equal the JAX XLA scan at a
set with bgbit 22. The kernel itself is held against the plain product on
the card in tests/test_torch_kernel_gpu.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import bootstrap as JB  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.ops import blind_rotate as JBR  # noqa: E402
from rs_tfhe_tpu.ops.pallas_step import fused_external_product  # noqa: E402
from rs_tfhe_tpu.ops.poly import (  # noqa: E402
    build_step_matrix,
    negacyclic_extend,
    polymul_small_by_torus_multi,
)
from rs_tfhe_tpu.torus import split_u32_limbs  # noqa: E402
from rs_tfhe_tpu_torch import bootstrap as PB  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_step as CS  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

#: a tiny set with bgbit 22 (digits up to 2^21, digit_limbs 3), as the Uint sets
WIDE = dataclasses.replace(
    JP.TEST_TINY,
    description="tiny set with 22-bit digits",
    tlwe_lv1=JP.TlweParams(n=128, alpha=1.0e-15),
    trlwe_lv1=JP.TrlweParams(n=128, alpha=1.0e-15),
    trgsw_lv1=JP.TrgswParams(n=128, nbit=7, bgbit=22, l=1, basebit=4, iks_t=5, alpha=1.0e-15),
)
_UINT = [f"SECURITY_UINT{k}" for k in range(1, 9)]


@pytest.fixture
def impl():
    saved = PC.config.step_impl
    yield lambda value: setattr(PC.config, "step_impl", value)
    PC.config.step_impl = saved


def test_plain_product_matches_k5_fused_external_product():
    """The shapes of tests/test_pallas_kernels.py:34-42: J=4, O=2, N=128,
    F=128, digits in [-32, 32)."""
    rng = np.random.default_rng(100)
    j, o, n, f = 4, 2, 128, 128
    t = rng.integers(0, 1 << 32, (j, o, n), dtype=np.uint32)
    d = rng.integers(-32, 32, (f, j, n)).astype(np.int32)
    xl = jnp.transpose(split_u32_limbs(negacyclic_extend(jnp.asarray(t))), (1, 3, 0, 2))
    k5 = fused_external_product(jnp.asarray(d).astype(jnp.int8).reshape(f, j * n), xl, 2, interpret=True)
    port = polymul_small_by_torus(torch.from_numpy(d), to_torch(t), 32)
    np.testing.assert_array_equal(to_numpy(port), np.asarray(k5))
    ref = polymul_small_by_torus_multi(jnp.asarray(d), build_step_matrix(jnp.asarray(t)), 1, 2)
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


@pytest.mark.parametrize("name", _UINT)
def test_plain_product_exact_for_wide_digits(name):
    """The Uint sets (bgbit 10-23, digit_limbs 2-3) at their real N: the
    plain product equals the JAX package's multi-limb product, with digits
    at the extremes of [-Bg/2, Bg/2)."""
    jp = getattr(JP, name)
    g = jp.trgsw_lv1
    rng = np.random.default_rng(101)
    t = rng.integers(0, 1 << 32, (2 * g.l, 2, jp.n1), dtype=np.uint32)
    d = rng.integers(-g.half_bg, g.half_bg, (2, 2 * g.l, jp.n1)).astype(np.int32)
    d[0, :, ::2] = -g.half_bg
    d[0, :, 1::2] = g.half_bg - 1
    port = polymul_small_by_torus(torch.from_numpy(d), to_torch(t), g.half_bg)
    ref = polymul_small_by_torus_multi(jnp.asarray(d), build_step_matrix(jnp.asarray(t)), jp.digit_limbs, 2)
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))


def test_plain_rotation_matches_xla_scan_at_bgbit_22():
    """The repair: at bgbit > 8 the port's plain rotation equals the JAX XLA
    scan (it refused such sets before)."""
    rng = np.random.default_rng(102)
    p, pp = WIDE, params_from(WIDE)
    assert p.digit_limbs > 1
    bsk = rng.integers(0, 1 << 32, (p.n0, 2 * p.trgsw_lv1.l, 2, p.n1), dtype=np.uint32)
    ct = rng.integers(0, 1 << 32, (4, p.n0 + 1), dtype=np.uint32)
    tv = rng.integers(0, 1 << 32, (2, p.n1), dtype=np.uint32)
    ref = np.asarray(JBR.blind_rotate(jnp.asarray(ct), jnp.asarray(tv), jnp.asarray(bsk), p))
    b_til, a_til = PBR.rotation_exponents(to_torch(ct), pp)
    np.testing.assert_array_equal(to_numpy(PBR.blind_rotate_plain(b_til, a_til, to_torch(tv), to_torch(bsk), pp)), ref)


def test_bootstrap_matches_jax_at_bgbit_22():
    """A whole bootstrap (and its decryption) at the bgbit-22 set with a JAX
    key carried across."""
    p, pp = WIDE, params_from(WIDE)
    sk = JSecretKey.generate(jax.random.key(103), p)
    ck = JCloudKey.generate(jax.random.key(104), sk)
    bits = np.array([True, False, False, True])
    ct = JT.lwe_encrypt_bool(jax.random.key(105), sk.lv0, jnp.asarray(bits), p.tlwe_lv0.alpha)
    arrays = {"testvec": np.asarray(ck.testvec), "bsk": np.asarray(ck.bsk), "ksk_limbs": np.asarray(ck.ksk_limbs)}
    out = PB.bootstrap(to_torch(np.asarray(ct)), PK.cloud_key_from_numpy(arrays, pp))
    np.testing.assert_array_equal(to_numpy(out), np.asarray(JB.bootstrap(ct, ck)))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, to_torch(np.asarray(sk.lv0))).numpy(), bits)


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
def test_pallas_route_equals_default(impl, per_ct_tv):
    """step_impl="pallas" (the per-step route; the plain product on the CPU)
    gives the default route's result, and counts no kernel launch here."""
    p = params_from(JP.TEST_TINY)
    rng = np.random.default_rng(106 + per_ct_tv)
    bsk = to_torch(rng.integers(0, 1 << 32, (p.n0, 2 * p.trgsw_lv1.l, 2, p.n1), dtype=np.uint32))
    ct = to_torch(rng.integers(0, 1 << 32, (5, p.n0 + 1), dtype=np.uint32))
    tv = to_torch(rng.integers(0, 1 << 32, (5, 2, p.n1) if per_ct_tv else (2, p.n1), dtype=np.uint32))
    default = PBR.blind_rotate(ct, tv, bsk, p)
    impl("pallas")
    before = CS.launches
    assert torch.equal(PBR.blind_rotate(ct, tv, bsk, p), default)
    assert CS.launches == before


def test_pallas_route_gates_on_port_keys(impl):
    """A NAND batch under step_impl="pallas" equals the default route's on
    the port's own keys and decrypts correctly."""
    from rs_tfhe_tpu_torch import gates

    p = params_from(JP.TEST_TINY)
    g = torch.Generator().manual_seed(108)
    sk = PK.SecretKey.generate(p, g)
    ck = PK.CloudKey.generate(sk, g)
    ma, mb = np.array([0, 0, 1, 1], bool), np.array([0, 1, 0, 1], bool)
    a = PT.lwe_encrypt_bool(g, sk.lv0, ma, p.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, sk.lv0, mb, p.tlwe_lv0.alpha)
    default = gates.nand(a, b, ck)
    impl("pallas")
    out = gates.nand(a, b, ck)
    assert torch.equal(out, default)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(out, sk.lv0).numpy(), ~(ma & mb))


def test_external_product_dispatch_and_wrapper():
    p = params_from(JP.TEST_TINY)
    rng = np.random.default_rng(109)
    l, n = p.trgsw_lv1.l, p.n1
    d = torch.from_numpy(rng.integers(-32, 32, (3, 2 * l, n)).astype(np.int32))
    t = to_torch(rng.integers(0, 1 << 32, (2 * l, 2, n), dtype=np.uint32))
    assert torch.equal(CS.external_product(d, t, p), polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))
    with pytest.raises(ValueError, match="CUDA"):
        CS.external_product_kernel(d, t, p)

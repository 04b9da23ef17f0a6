"""PyTorch port: the Nussbaumer step (rs_tfhe_tpu_torch.ops.nussbaumer) and
the step_impl="nussbaumer" route, held bit for bit (tolerance 0) against the
JAX package's rs_tfhe_tpu.ops.nussbaumer: the bounds for every parameter set,
the transforms, the prepared BSK operand and the step product on random
operands, and a whole NAND (the fixture tests/vectors/torch_port_tiny_parallel.npz
holds JAX's). On the CPU the pointwise s16 dots run their plain version; the
card's kernel (the probe dot's s16 unit) is held against it in
tests/test_torch_kernel_gpu.py."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu.ops import nussbaumer as JN  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import gates, key  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_probes  # noqa: E402
from rs_tfhe_tpu_torch.ops import nussbaumer as PN  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus  # noqa: E402
from rs_tfhe_tpu_torch.params import TEST_TINY, params_from  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def impl():
    saved = PC.config.step_impl
    yield lambda value: setattr(PC.config, "step_impl", value)
    PC.config.step_impl = saved


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_parallel.npz")


@pytest.mark.parametrize("name", sorted(JP.ALL_SECURITY_SETS))
def test_check_bounds_equals_jax(name):
    jp = JP.ALL_SECURITY_SETS[name]
    assert PN.check_bounds(params_from(jp)) == JN.check_bounds(jp)


def test_check_bounds_by_family():
    """FAST, strict, 80/110-bit and TEST_TINY pass; RADIX, NIBBLE and the
    Uint sets fail (their digits or sums leave the int16/int32 bounds)."""
    passing = {"SECURITY_128_BIT_FAST", "SECURITY_128_BIT", "SECURITY_80_BIT", "SECURITY_110_BIT"}
    for name, jp in JP.ALL_SECURITY_SETS.items():
        assert PN.check_bounds(params_from(jp)) == (name in passing), name
    assert PN.check_bounds(TEST_TINY)


def _operands(jp, batch, seed):
    """A random step key with the extreme words planted, and digits at the
    ends of [-Bg/2, Bg/2)."""
    g = jp.trgsw_lv1
    rng = np.random.default_rng(seed)
    bsk_i = rng.integers(0, 1 << 32, (2 * g.l, 2, jp.n1), dtype=np.uint32)
    bsk_i[0, 0, :4] = [0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0]
    d = rng.integers(-g.half_bg, g.half_bg, (batch, 2 * g.l, jp.n1)).astype(np.int32)
    d[0, :, ::2] = -g.half_bg
    d[-1, :, 1::2] = g.half_bg - 1
    return bsk_i, d


@pytest.mark.parametrize("name,batch", [("TEST_TINY", 5), ("SECURITY_128_BIT_FAST", 2)])
def test_prepare_and_step_equal_jax(name, batch):
    """prepare_bsk_step and external_product_step equal JAX's, and the step
    equals the direct negacyclic product."""
    jp = getattr(JP, name)
    pp = params_from(jp)
    bsk_i, d = _operands(jp, batch, seed=batch)
    jbop = np.asarray(JN.prepare_bsk_step(jnp.asarray(bsk_i), jp))
    jout = np.asarray(JN.external_product_step(jnp.asarray(d), jnp.asarray(jbop), jp))
    bop = PN.prepare_bsk_step(to_torch(bsk_i, "cpu"), pp)
    assert bop.dtype == torch.int16 and bop.shape == jbop.shape
    np.testing.assert_array_equal(bop.numpy(), jbop)
    out = PN.external_product_step(torch.from_numpy(d), bop, pp)
    np.testing.assert_array_equal(to_numpy(out), jout)
    ref = polymul_small_by_torus(torch.from_numpy(d), to_torch(bsk_i, "cpu"), pp.trgsw_lv1.half_bg)
    assert torch.equal(out, ref)


def test_transforms_equal_jax():
    """The gather-table transforms equal JAX's loops of static shifts,
    on the widest int16 inputs the bounds allow and on wrapping int32."""
    m, r = 16, PN.R
    rng = np.random.default_rng(7)
    a = rng.integers(-(1 << 12), 1 << 12, (3, r, m)).astype(np.int16)
    np.testing.assert_array_equal(PN._fwd(torch.from_numpy(a), m, r).numpy(),
                                  np.asarray(JN._fwd(jnp.asarray(a), m, r)))
    ch = rng.integers(-(1 << 31), 1 << 31, (3, 2 * r, m), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(PN._inv_fold_div(torch.from_numpy(ch), m, r).numpy(),
                                  np.asarray(JN._inv_fold_div(jnp.asarray(ch), m, r)))


def test_limb_and_circulant_helpers_equal_jax():
    """The port's copies of the JAX helpers the step needs: balanced int8
    limbs (non-planar), the static negacyclic roll at every shift, and the
    circulant rows."""
    from rs_tfhe_tpu.ops import poly as JPOLY
    from rs_tfhe_tpu.torus import split_u32_limbs as jsplit
    from rs_tfhe_tpu_torch.ops import poly as PPOLY
    from rs_tfhe_tpu_torch.torus import split_u32_limbs

    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 32, (3, 16), dtype=np.uint32)
    words[0, :4] = [0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x807F7F80]
    np.testing.assert_array_equal(split_u32_limbs(to_torch(words, "cpu")).numpy(),
                                  np.asarray(jsplit(jnp.asarray(words))))
    x = rng.integers(-(1 << 15), 1 << 15, (2, 16)).astype(np.int16)
    for shift in range(-1, 33):
        np.testing.assert_array_equal(PPOLY.negacyclic_static_roll(torch.from_numpy(x), shift).numpy(),
                                      np.asarray(JPOLY.negacyclic_static_roll(jnp.asarray(x), shift)), err_msg=shift)
    ext = rng.integers(-(1 << 15), 1 << 15, (2, 32)).astype(np.int16)
    np.testing.assert_array_equal(PPOLY.circulant_rows(torch.from_numpy(ext), 16).numpy(),
                                  np.asarray(JPOLY.circulant_rows(jnp.asarray(ext), 16)))


def test_pointwise_dot_plain_and_k_check():
    """On the CPU the pointwise dot is the plain s16 dot, point by point, and
    counts no launch; a K off the tensor-core tile's multiple raises."""
    g = torch.Generator().manual_seed(8)
    lhs = torch.randint(-(1 << 15), 1 << 15, (4, 3, 32), generator=g, dtype=torch.int16)
    bop = torch.randint(-(1 << 15), 1 << 15, (4, 32, 24), generator=g, dtype=torch.int16)
    name = f"probes.launches.{PN.DOT_NAME}"
    before = profiling.counters().get(name, 0)
    out = PN.pointwise_dot(lhs, bop)
    assert profiling.counters().get(name, 0) == before
    assert torch.equal(out, torch.stack([cuda_probes.dot_plain(lhs[t], bop[t]) for t in range(4)]))
    with pytest.raises(ValueError, match="multiple of 16"):
        PN.pointwise_dot(lhs[..., :24], bop[:, :24])


def test_nand_route_equals_jax_and_auto(impl):
    """A NAND at B = 4 under step_impl="nussbaumer" equals JAX's (the
    parallel fixture) and the port's auto route, and decrypts."""
    v = np.load(VEC)
    ck = key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")}, TEST_TINY, "cpu")
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    a, b = to_torch(v["ct_a"][:4], "cpu"), to_torch(v["ct_b"][:4], "cpu")
    auto = gates.nand(a, b, ck)
    impl("nussbaumer")
    out = gates.nand(a, b, ck)
    np.testing.assert_array_equal(to_numpy(out), v["nand_nussbaumer_b4"])
    assert torch.equal(out, auto)
    bits = v["bits"][:, :4]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), ~(bits[0] & bits[1]))


def test_route_ignores_a_multibit_key(impl):
    """Under "nussbaumer" a multi-bit key takes the CMUX rotation, as
    "pallas" does (the auto route would send B = 2 to the multi-bit one)."""
    v = np.load(VEC)
    ck_mb = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    a, b = to_torch(v["ct_a"][:2], "cpu"), to_torch(v["ct_b"][:2], "cpu")
    impl("nussbaumer")
    out = gates.nand(a, b, ck_mb)
    impl("auto")
    std = gates.nand(a, b, key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")},
                                                   TEST_TINY, "cpu"))
    assert torch.equal(out, std) and not torch.equal(out, gates.nand(a, b, ck_mb))


def test_route_raises_outside_the_bounds(impl):
    p = params_from(JP.SECURITY_UINT4)
    impl("nussbaumer")
    with pytest.raises(ValueError, match="bounds not satisfied"):
        PBR.blind_rotate(torch.zeros((1, p.n0 + 1), dtype=torch.int32), key.gen_testvec(p, "cpu"),
                         torch.zeros((p.n0, 2 * p.trgsw_lv1.l, 2, p.n1), dtype=torch.int32), p)

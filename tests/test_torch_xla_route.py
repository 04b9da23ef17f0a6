"""PyTorch port: step_impl="xla", the JAX package's forced dot_general path
(rs_tfhe_tpu/config.py:29), is the port's plain rotation
`ops.blind_rotate.blind_rotate_plain` on the ciphertext's device. NAND under
it is held bit for bit (tolerance 0) against NAND under the JAX package's
"xla" at TEST_TINY, on JAX keys carried into the port, with a standard key
and with a multi-bit key at B = 2: there JAX's "auto" would take the
multi-bit rotation, "xla" takes the standard one in both packages. On the
card the route is held in tests/test_torch_kernel_gpu.py; the fused TPU
schedules go on raising (tests/test_torch_multibit.py holds them at the
rotation)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import gates as JG  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.config import config as JAX_CONFIG  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import gates as PG  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

PTINY = params_from(TEST_TINY)
BATCH = 2  # at or below the multi-bit cap (4 at TEST_TINY): "auto" would take the multi-bit rotation


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
def step_impl():
    """Set step_impl in both packages for one test; restore both after it."""
    saved = JAX_CONFIG.step_impl, PC.config.step_impl

    def set_both(value):
        JAX_CONFIG.step_impl = PC.config.step_impl = value

    yield set_both
    JAX_CONFIG.step_impl, PC.config.step_impl = saved


@pytest.fixture(scope="module", params=["standard", "multibit"])
def case(request):
    """JAX keys and a NAND's inputs at B = 2, and the same words in the port."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(160), TEST_TINY)
    jck = JCloudKey.generate(jax.random.key(161), jsk, multibit=mb)
    arrays = {"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk),
              "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    rng = np.random.default_rng(162)
    bits = [jnp.asarray(rng.integers(0, 2, BATCH).astype(bool)) for _ in range(2)]
    ja, jb = (JT.lwe_encrypt_bool(jax.random.key(163 + i), jsk.lv0, bits[i], TEST_TINY.tlwe_lv0.alpha)
              for i in range(2))
    port = (to_torch(np.asarray(ja), "cpu"), to_torch(np.asarray(jb), "cpu"),
            PK.cloud_key_from_numpy(arrays, PTINY, "cpu"))
    return (ja, jb, jck), port


def test_xla_nand_equals_jax_xla_nand(case, step_impl):
    """gates.nand keys JAX's jit cache on step_impl, so the JAX NAND below is
    traced afresh under "xla"."""
    (ja, jb, jck), (pa, pb, pck) = case
    step_impl("xla")
    np.testing.assert_array_equal(to_numpy(PG.nand(pa, pb, pck)), np.asarray(JG.nand(ja, jb, jck)))


def test_xla_takes_the_standard_rotation_with_either_key(case, step_impl):
    """Under "xla" a NAND equals "auto"'s with the key's standard part alone
    (the port's auto on the CPU is the plain rotation too); a multi-bit
    key's "auto" takes the multi-bit rotation at B = 2, another function."""
    _, (pa, pb, pck) = case
    standard = PK.CloudKey(pck.testvec, pck.bsk, pck.ksk_limbs, PTINY)
    step_impl("auto")
    auto = PG.nand(pa, pb, pck)
    auto_standard = PG.nand(pa, pb, standard)
    step_impl("xla")
    assert torch.equal(PG.nand(pa, pb, pck), auto_standard)
    assert torch.equal(auto, auto_standard) == (pck.bsk_mb is None)


def test_xla_is_a_route_of_the_port(step_impl):
    assert "xla" in PC.STEP_IMPLS
    step_impl("xla")
    assert PC.step_impl() == "xla"
    for value in ("fused", "fused_small", "fused_wide", "fused_tile"):
        step_impl(value)
        with pytest.raises(ValueError, match="not ported"):
            PC.step_impl()

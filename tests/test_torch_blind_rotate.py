"""PyTorch port: the blind rotation, the function of the hand-written CUDA
kernel. Its plain PyTorch version is held bit-exact (tolerance 0) against
each TPU kernel it replaces, run in interpret mode as
tests/test_pallas_kernels.py runs them:

  K1 fused_blind_rotate        (batch-tile kernel)
  K2 fused_blind_rotate_wide   (step-major kernel)
  K3 fused_blind_rotate_small  (commuted small-batch kernel)

and against the XLA scan. The kernel itself is held against the plain
version on the card in tests/test_torch_kernel_gpu.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu.key import round_bsk  # noqa: E402
from rs_tfhe_tpu.ops import blind_rotate as JBR  # noqa: E402
from rs_tfhe_tpu.ops.pallas_blind_rotate import (  # noqa: E402
    fused_blind_rotate,
    fused_blind_rotate_small,
    fused_blind_rotate_wide,
    prepare_bsk_limbs,
    prepare_bsk_vecs,
)
from rs_tfhe_tpu_torch import _build  # noqa: E402
from rs_tfhe_tpu_torch import params as PP  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

#: the smallest kernel-eligible set of tests/test_pallas_kernels.py (N = 128)
KP = JP.TfheParams(
    security_bits=0,
    description="kernel-eligible tiny set",
    tlwe_lv0=JP.TlweParams(n=8, alpha=1.0e-9),
    tlwe_lv1=JP.TlweParams(n=128, alpha=1.0e-12),
    trlwe_lv1=JP.TrlweParams(n=128, alpha=1.0e-12),
    trgsw_lv1=JP.TrgswParams(n=128, nbit=7, bgbit=6, l=2, basebit=2, iks_t=8, alpha=1.0e-12),
)
KP_ROUNDED = dataclasses.replace(KP, bsk_round_bits=8)


def _case(p, batch, per_ct_tv, rounded, seed):
    """Random BSK, ciphertexts and test vector(s); returns the JAX operands
    (b~, a~ [n0, B] as the TPU kernels take them) and the port's."""
    rng = np.random.default_rng(seed)
    n0, n1 = p.n0, p.n1
    bsk = jnp.asarray(rng.integers(0, 1 << 32, (n0, 2 * p.trgsw_lv1.l, 2, n1), dtype=np.uint32))
    if rounded:
        bsk = round_bsk(bsk, 8)
    ct = jnp.asarray(rng.integers(0, 1 << 32, (batch, n0 + 1), dtype=np.uint32))
    tv_shape = (batch, 2, n1) if per_ct_tv else (2, n1)
    tv = jnp.asarray(rng.integers(0, 1 << 32, tv_shape, dtype=np.uint32))
    b_til = ((2 * n1 - JBR.modswitch(ct[:, n0], p)) % (2 * n1)).astype(jnp.int32)
    a_til = JBR.modswitch(ct[:, :n0], p).T
    port = PBR.blind_rotate_plain(
        torch.from_numpy(np.array(b_til)),
        torch.from_numpy(np.asarray(a_til).T.copy()),
        to_torch(np.asarray(tv)),
        to_torch(np.asarray(bsk)),
        PP.params_from(p),
    )
    return dict(b_til=b_til, a_til=a_til, tv=tv, bsk=bsk, ct=ct), to_numpy(port)


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
def test_plain_matches_k1_fused_blind_rotate(per_ct_tv):
    j, port = _case(KP, 128, per_ct_tv, False, seed=11)
    ref = fused_blind_rotate(
        j["b_til"], j["a_til"], j["tv"], prepare_bsk_limbs(j["bsk"]), KP, interpret=True
    )
    np.testing.assert_array_equal(port, np.asarray(ref))


def test_plain_matches_k1_rounded_bsk_drop_limbs():
    """24-bit BSK: the TPU kernel skips the zero low limb plane
    (drop_limbs=1); the plain version multiplies whole words."""
    j, port = _case(KP_ROUNDED, 128, False, True, seed=12)
    ref = fused_blind_rotate(
        j["b_til"], j["a_til"], j["tv"], prepare_bsk_limbs(j["bsk"]), KP_ROUNDED,
        interpret=True, drop_limbs=1,
    )
    np.testing.assert_array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv_drop_limbs"])
def test_plain_matches_k2_fused_blind_rotate_wide(per_ct_tv):
    p = KP_ROUNDED if per_ct_tv else KP
    j, port = _case(p, 256, per_ct_tv, per_ct_tv, seed=13)
    ref = fused_blind_rotate_wide(
        j["b_til"], j["a_til"], j["tv"], prepare_bsk_limbs(j["bsk"]), p,
        interpret=True, super_b=256, drop_limbs=int(per_ct_tv),
    )
    np.testing.assert_array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("batch", [1, 2])
def test_plain_matches_k3_fused_blind_rotate_small(batch):
    j, port = _case(KP, batch, False, False, seed=14 + batch)
    ref = fused_blind_rotate_small(
        j["b_til"], j["a_til"], j["tv"], prepare_bsk_vecs(j["bsk"]), KP, interpret=True
    )
    np.testing.assert_array_equal(port, np.asarray(ref))


def test_plain_matches_k3_rounded_per_ct_tv():
    j, port = _case(KP_ROUNDED, 2, True, True, seed=17)
    ref = fused_blind_rotate_small(
        j["b_til"], j["a_til"], j["tv"], prepare_bsk_vecs(j["bsk"], drop_limbs=1), KP_ROUNDED,
        interpret=True, drop_limbs=1,
    )
    np.testing.assert_array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
def test_blind_rotate_matches_xla_scan_tiny(per_ct_tv):
    """The port's `blind_rotate` entry point (modswitch + dispatch; a CPU
    tensor runs the plain version) against the JAX XLA scan at TEST_TINY."""
    p = JP.TEST_TINY
    j, _ = _case(p, 8, per_ct_tv, False, seed=18)
    ref = JBR.blind_rotate(j["ct"], j["tv"], j["bsk"], p)
    before = CBR.launches
    port = PBR.blind_rotate(
        to_torch(np.asarray(j["ct"])), to_torch(np.asarray(j["tv"])),
        to_torch(np.asarray(j["bsk"])), PP.params_from(p),
    )
    np.testing.assert_array_equal(to_numpy(port), np.asarray(ref))
    assert CBR.launches == before  # the CPU path never counts as a launch


def test_rotation_exponents_match():
    p = JP.SECURITY_128_BIT_FAST
    ct = np.random.default_rng(19).integers(0, 1 << 32, (5, p.n0 + 1), dtype=np.uint32)
    b_til, a_til = PBR.rotation_exponents(to_torch(ct), PP.params_from(p))
    ref_b = (2 * p.n1 - JBR.modswitch(jnp.asarray(ct)[:, p.n0], p)) % (2 * p.n1)
    np.testing.assert_array_equal(b_til.numpy(), np.asarray(ref_b))
    np.testing.assert_array_equal(a_til.numpy(), np.asarray(JBR.modswitch(jnp.asarray(ct)[:, : p.n0], p)))


def test_kernel_wrapper_takes_cuda_tensors_only():
    p = PP.TEST_TINY
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        CBR.blind_rotate_kernel(
            z(4, dtype=torch.int32), z(4, p.n0, dtype=torch.int32), z(2, p.n1, dtype=torch.int32),
            z(p.n0, 2 * p.trgsw_lv1.l, 2, p.n1, dtype=torch.int32), p,
        )


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_OUT_ROOT", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_select_tile():
    """The wrappers' tile choice, `fit_tile`: the largest power of two up to
    the kernel's `max_tile` (the whole-rotation kernel's: 8 up to N=1024, 4
    at 2048, 2 at 4096; the multi-bit kernel's: 4, 2, 1) that still gives
    each of 132 SMs a block."""
    sms = 132
    assert CBR.fit_tile(4096, 8, sms) == 8
    assert CBR.fit_tile(512, 8, sms) == 2
    assert CBR.fit_tile(1, 8, sms) == 1
    assert CBR.fit_tile(8, 8, sms) == 1
    assert CBR.fit_tile(4096, 4, sms) == 4
    assert CBR.fit_tile(4096, 2, sms) == 2
    assert CBR.fit_tile(528, 4, sms) == 4
    assert CBR.fit_tile(264, 2, sms) == 2
    assert CBR.fit_tile(256, 2, sms) == 1

"""PyTorch port: the hand-written kernels on the card, held bit for bit
against their plain PyTorch versions: the blind rotation
(csrc/blind_rotate.cu), the multi-bit blind rotation
(csrc/blind_rotate_mb.cu) and the external-product step
(csrc/external_product.cu).

Every test here needs a CUDA device (marker `gpu`) and skips without one:
the kernels have no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_kernel_gpu.py --noconftest -o addopts="" -q
"""

import pytest

torch = pytest.importorskip("torch")

from rs_tfhe_tpu_torch import _build  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import params as P  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as BR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate_mb as CMB  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_step as CS  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, p, batch, per_ct_tv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    n = p.n1
    bsk = rnd((p.n0, 2 * p.trgsw_lv1.l, 2, n))
    tv = rnd((batch, 2, n) if per_ct_tv else (2, n))
    return rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n), tv, bsk


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_kernel_matches_plain_every_tile(dev, tile, per_ct_tv):
    """TEST_TINY, a batch that no tile divides (the ragged last block)."""
    args = _inputs(dev, P.TEST_TINY, 11, per_ct_tv, seed=tile)
    out = CBR.blind_rotate_kernel(*args, P.TEST_TINY, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 8), ("SECURITY_128_BIT", 4), ("SECURITY_128_BIT_RADIX", 2)]
)
def test_kernel_matches_plain_full_width(dev, name, batch):
    p = getattr(P, name)
    args = _inputs(dev, p, batch, False, seed=batch)
    out = CBR.blind_rotate_kernel(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, p))


@pytest.mark.parametrize(
    "kernel,at_1024", [("tfhe_blind_rotate", 8), ("tfhe_blind_rotate_mb", 4), ("tfhe_external_product", 8)]
)
def test_max_tile_per_ring_size(dev, kernel, at_1024):
    """Each kernel's largest tile, as its source states it and the wrappers
    read it: constant up to N=1024, then halved per doubling of N."""
    max_tile = getattr(_build.load(), f"{kernel}_max_tile")
    assert [max_tile(log_n) for log_n in range(6, 13)] == [at_1024] * 5 + [at_1024 // 2, at_1024 // 4]


def test_dispatch_launches_kernel_and_counts(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk = _inputs(dev, p, 3, False, seed=7)
    ct = torch.randint(-(1 << 31), 1 << 31, (3, p.n0 + 1), dtype=torch.int32, device=dev)
    before, tiles = CBR.launches, CBR.launched_tiles.copy()
    out = BR.blind_rotate(ct, tv, bsk, p)
    assert CBR.launches == before + 1
    assert CBR.launched_tiles - tiles == {(p.n1, 1): 1}
    b_til, a_til = BR.rotation_exponents(ct, p)
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk = _inputs(dev, p, 4, False, seed=8)
    with pytest.raises(TypeError):
        CBR.blind_rotate_kernel(b_til, a_til.to(torch.int64), tv, bsk, p)
    with pytest.raises(ValueError, match="shape"):
        CBR.blind_rotate_kernel(b_til, a_til[:, :-1].contiguous(), tv, bsk, p)
    with pytest.raises(ValueError, match="contiguous"):
        CBR.blind_rotate_kernel(b_til, a_til.t().contiguous().t(), tv, bsk, p)
    with pytest.raises(ValueError, match="on cpu"):
        CBR.blind_rotate_kernel(b_til, a_til, tv.cpu(), bsk, p)


def _mb_inputs(dev, p, batch, per_ct_tv, seed):
    b_til, a_til, tv, _ = _inputs(dev, p, batch, per_ct_tv, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    shape = (p.n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, p.n1)
    bsk_mb = torch.randint(-(1 << 31), 1 << 31, shape, generator=g, dtype=torch.int32, device=dev)
    return b_til, a_til, tv, bsk_mb


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile", [1, 2, 4])
def test_mb_kernel_matches_plain_every_tile(dev, tile, per_ct_tv):
    args = _mb_inputs(dev, P.TEST_TINY, 11, per_ct_tv, seed=20 + tile)
    out = CMB.blind_rotate_mb_kernel(*args, P.TEST_TINY, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_mb_plain(*args, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 2), ("SECURITY_128_BIT", 4), ("SECURITY_128_BIT_RADIX", 1)]
)
def test_mb_kernel_matches_plain_full_width(dev, name, batch):
    p = getattr(P, name)
    args = _mb_inputs(dev, p, batch, True, seed=30 + batch)
    out = CMB.blind_rotate_mb_kernel(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_mb_plain(*args, p))


def _step_inputs(dev, p, rows, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    l, n, hb = p.trgsw_lv1.l, p.n1, p.trgsw_lv1.half_bg
    d = torch.randint(-hb, hb, (rows, 2 * l, n), generator=g, dtype=torch.int32, device=dev)
    t = torch.randint(-(1 << 31), 1 << 31, (2 * l, 2, n), generator=g, dtype=torch.int32, device=dev)
    return d, t


@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_step_kernel_matches_plain_every_tile(dev, tile):
    d, t = _step_inputs(dev, P.TEST_TINY, 11, seed=40 + tile)
    out = CS.external_product_kernel(d, t, P.TEST_TINY, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, polymul_small_by_torus(d, t, P.TEST_TINY.trgsw_lv1.half_bg))


@pytest.mark.parametrize(
    "name,rows", [("SECURITY_128_BIT_FAST", 256), ("SECURITY_128_BIT", 64), ("SECURITY_UINT4", 8)]
)
def test_step_kernel_matches_plain_full_width(dev, name, rows):
    p = getattr(P, name)
    d, t = _step_inputs(dev, p, rows, seed=rows)
    out = CS.external_product_kernel(d, t, p)
    torch.cuda.synchronize()
    assert torch.equal(out, polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))


def test_routes_launch_their_kernels_and_count(dev):
    """A multi-bit key launches the multi-bit kernel once;
    step_impl="pallas" launches the step kernel once per step; both equal
    their plain versions."""
    p = P.TEST_TINY
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, 3, False, seed=50)
    _, _, _, bsk = _inputs(dev, p, 3, False, seed=51)
    ct = torch.randint(-(1 << 31), 1 << 31, (3, p.n0 + 1), dtype=torch.int32, device=dev)
    b_til, a_til = BR.rotation_exponents(ct, p)
    before = CMB.launches
    out = BR.blind_rotate(ct, tv, bsk, p, bsk_mb=bsk_mb)
    assert CMB.launches == before + 1
    assert torch.equal(out, BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, p))
    saved = PC.config.step_impl
    PC.config.step_impl = "pallas"
    try:
        before = CS.launches
        out = BR.blind_rotate(ct, tv, bsk, p)
        assert CS.launches == before + p.n0
    finally:
        PC.config.step_impl = saved
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, 4, False, seed=52)
    with pytest.raises(ValueError, match="shape"):
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb[:-1].contiguous(), p)
    with pytest.raises(ValueError, match="on cpu"):
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb.cpu(), p)
    d, t = _step_inputs(dev, p, 4, seed=53)
    with pytest.raises(TypeError):
        CS.external_product_kernel(d.to(torch.int64), t, p)
    with pytest.raises(ValueError, match="contiguous"):
        CS.external_product_kernel(d.transpose(0, 1).contiguous().transpose(0, 1), t, p)
